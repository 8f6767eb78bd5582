"""SD stack loading: the twin of polyp_tpu/cli/common.py::load_sd_stack.

Random initialisation only in this slice: importing a local diffusers
checkpoint (`pretrained_dir`) comes with the LoRA slice. The modules are
built on the meta device and then materialised on `device` and filled from
one seeded `torch.Generator` there, so a full-width stack is made directly
on the card without a CPU copy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class SDStack:
    unet: nn.Module
    vae: nn.Module
    text: nn.Module
    tokenizer: object


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's init scheme (flax defaults): dense and conv kernels
    normal with std 1/√fan_in (lecun), biases 0, norm scales 1, token
    embeddings N(0, 0.02), position embeddings N(0, 0.01)."""
    for name, p in module.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        if isinstance(module.get_submodule(owner), nn.Embedding):
            std = 0.01 if "position" in owner else 0.02
        elif leaf == "bias":
            p.zero_()
            continue
        elif p.ndim == 1:  # GroupNorm / LayerNorm scales
            p.fill_(1.0)
            continue
        else:
            std = 1.0 / math.sqrt(p[0].numel())
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                * std)


def load_sd_stack(pretrained_dir: str | None = None,
                  dtype: torch.dtype = torch.bfloat16, tiny: bool = False,
                  device: torch.device | str = "cuda",
                  seed: int = 0) -> SDStack:
    """SD-v1-4 components (UNet, VAE decoder, CLIP text encoder, tokenizer)
    randomly initialised on `device` from `seed`. `tiny=True` swaps in the
    miniature stack and a hash tokenizer, as the reference does. The stack
    is built on the card unless the caller passes `device="cpu"`; with no
    card it raises rather than move to the CPU on its own."""
    from polyp_tpu_torch.models import (
        SD14_TEXT_CONFIG, TINY_TEXT_CONFIG, AutoencoderKL, CLIPTextModel,
        HashTokenizer, load_tokenizer, sd14_unet, tiny_condition_unet,
        tiny_vae)

    if pretrained_dir is not None:
        raise NotImplementedError(
            "polyp_tpu_torch does not import diffusers checkpoints yet "
            "(ROADMAP.md Queue 1, slice 5); pass pretrained_dir=None")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "load_sd_stack builds on the CUDA card by default and no card "
            "is present; pass device='cpu' to build the stack on the CPU")
    if tiny:
        unet = tiny_condition_unet(dtype=dtype, device="meta")
        vae = tiny_vae(dtype=dtype, device="meta")
        text = CLIPTextModel(TINY_TEXT_CONFIG, dtype=dtype, device="meta")
        tokenizer = HashTokenizer(vocab_size=TINY_TEXT_CONFIG.vocab_size,
                                  max_length=TINY_TEXT_CONFIG.max_length)
    else:
        unet = sd14_unet(dtype=dtype, device="meta")
        vae = AutoencoderKL(dtype=dtype, device="meta")
        text = CLIPTextModel(SD14_TEXT_CONFIG, dtype=dtype, device="meta")
        tokenizer = load_tokenizer(None, SD14_TEXT_CONFIG.max_length)
    print("[polyp-tpu-torch] no pretrained dir — using RANDOM INIT "
          "(smoke mode)")
    gen = torch.Generator(device).manual_seed(seed)
    modules = []
    for m in (unet, vae, text):
        m = m.to_empty(device=device)
        init_weights_(m, gen)
        modules.append(m.eval())
    return SDStack(*modules, tokenizer=tokenizer)
