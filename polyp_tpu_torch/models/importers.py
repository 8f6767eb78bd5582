"""Weight carrier: the JAX package's parameter trees → the port's state dicts.

The exact inverse of the reference's diffusers/transformers importer rules
(polyp_tpu/models/importers.py:148-301): flax paths are renamed back to
diffusers' keys (`down_0_res_0` → `down_blocks.0.resnets.0`, `to_out` →
`to_out.0`, `ff_net_0_proj` → `ff.net.0.proj`, ...) and leaves back to
torch layouts (conv HWIO → OIHW, dense [in, out] → [out, in], norm
`scale` → `weight`). A checkpoint imported into polyp_tpu thus comes back
key for key and bit for bit, and both packages can run the same weights.

Each function takes the parameter tree as nested dicts of numpy arrays
(`params` of `model.init`, or an imported tree) and returns a state dict of
fp32 tensors for `load_state_dict(..., strict=True)`.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

# (pattern, replacement) applied in order to each '/'-joined flax path
Rule = tuple[str, str]

_BLOCK_RULES: list[Rule] = [
    (r"(^|/)down_(\d+)_res_(\d+)/", r"\1down_blocks.\2.resnets.\3/"),
    (r"(^|/)down_(\d+)_attn_(\d+)/", r"\1down_blocks.\2.attentions.\3/"),
    (r"(^|/)down_(\d+)_downsample/", r"\1down_blocks.\2.downsamplers.0/"),
    (r"(^|/)up_(\d+)_res_(\d+)/", r"\1up_blocks.\2.resnets.\3/"),
    (r"(^|/)up_(\d+)_attn_(\d+)/", r"\1up_blocks.\2.attentions.\3/"),
    (r"(^|/)up_(\d+)_upsample/", r"\1up_blocks.\2.upsamplers.0/"),
    (r"(^|/)mid_res_(\d+)/", r"\1mid_block.resnets.\2/"),
    (r"(^|/)mid_attn/", r"\1mid_block.attentions.0/"),
    (r"(^|/)transformer_blocks_(\d+)/", r"\1transformer_blocks.\2/"),
    (r"(^|/)ff/ff_net_0_proj/", r"\1ff.net.0.proj/"),
    (r"(^|/)ff/ff_net_2/", r"\1ff.net.2/"),
    (r"(^|/)to_out/", r"\1to_out.0/"),
    # the VAE's SpatialSelfAttention nests its projections under `attention`
    (r"(^|/)attention/", r"\1"),
]

_CLIP_RULES: list[Rule] = [
    (r"^token_embedding$", r"text_model/embeddings/token_embedding/weight"),
    (r"^position_embedding$",
     r"text_model/embeddings/position_embedding/weight"),
    (r"^layer_(\d+)/(fc1|fc2)/", r"text_model/encoder/layers.\1/mlp/\2/"),
    (r"^layer_(\d+)/", r"text_model/encoder/layers.\1/"),
    (r"^final_layer_norm/", r"text_model/final_layer_norm/"),
]


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts → {'a/b/c': leaf}."""
    flat: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _to_torch_leaf(name: str, val: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if val.ndim == 4:
            return "weight", np.transpose(val, (3, 2, 0, 1))  # HWIO → OIHW
        return "weight", np.transpose(val)  # [in, out] → [out, in]
    if name == "scale":
        return "weight", val
    return name, val


def _convert(tree: dict, rules: list[Rule]) -> dict[str, torch.Tensor]:
    compiled = [(re.compile(p), r) for p, r in rules]
    out: dict[str, torch.Tensor] = {}
    for path, val in _flatten(tree).items():
        for pat, repl in compiled:
            path = pat.sub(repl, path)
        *parents, leaf = path.split("/")
        if leaf in ("kernel", "scale", "bias"):
            leaf, val = _to_torch_leaf(leaf, val)
        key = ".".join([*parents, leaf])
        if key in out:
            raise KeyError(f"two parameters map to {key}")
        out[key] = torch.from_numpy(np.array(val, np.float32))  # a copy
    return out


def _params(tree: dict) -> dict:
    """Accept `{'params': ...}` variables or the bare params tree."""
    return tree["params"] if set(tree) == {"params"} else tree


def unet_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """polyp_tpu UNet2DCondition params → the port's UNet2DCondition state
    dict (diffusers UNet2DConditionModel keys). The rules are local to a
    path, so the params of any one block (ResnetBlock2D, Transformer2D,
    SpatialSelfAttention, ...) give that block's state dict."""
    return _convert(_params(params), _BLOCK_RULES)


def vae_decoder_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """polyp_tpu AutoencoderKL params → the port's AutoencoderKL state dict:
    `decoder.*` and `post_quant_conv.*` (the encoder side is dropped)."""
    p = _params(params)
    keep = {k: p[k] for k in ("decoder", "post_quant_conv")}
    return _convert(keep, _BLOCK_RULES)


def scales_from_jax(scales: dict[str, Any]) -> dict[str, Any]:
    """polyp_tpu calibrated quantization scales ({flax layer path: float or
    per-timestep table}, e.g. `down_0_attn_0/transformer_blocks_0/ff/
    ff_net_0_proj`) → the port's keys (the module names, e.g.
    `down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj`), by
    the same rules as the weights, so both packages can run with one set of
    scales."""
    compiled = [(re.compile(p), r) for p, r in _BLOCK_RULES]
    out: dict[str, Any] = {}
    for path, val in scales.items():
        path += "/"
        for pat, repl in compiled:
            path = pat.sub(repl, path)
        key = path.rstrip("/").replace("/", ".")
        if key in out:
            raise KeyError(f"two scales map to {key}")
        out[key] = val
    return out


def clip_text_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """polyp_tpu CLIPTextModel params → the port's CLIPTextModel state dict
    (transformers CLIPTextModel keys)."""
    return _convert(_params(params), _CLIP_RULES)


def tiny_decoder_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """polyp_tpu TinyDecoder params → the port's TinyDecoder state dict:
    the flax module names are kept (`in_block_0/conv1` →
    `in_block_0.conv1`), conv kernels HWIO → OIHW."""
    return _convert(_params(params), [])
