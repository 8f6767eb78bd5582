"""Weight carrier: the JAX package's parameter trees → the port's state dicts.

The exact inverse of the reference's diffusers/transformers importer rules
(polyp_tpu/models/importers.py:148-301): flax paths are renamed back to
diffusers' keys (`down_0_res_0` → `down_blocks.0.resnets.0`, `to_out` →
`to_out.0`, `ff_net_0_proj` → `ff.net.0.proj`, ...) and leaves back to
torch layouts (conv HWIO → OIHW, dense [in, out] → [out, in], norm
`scale` → `weight`). A checkpoint imported into polyp_tpu thus comes back
key for key and bit for bit, and both packages can run the same weights.

Each `*_from_jax` function takes the parameter tree as nested dicts of
numpy arrays (`params` of `model.init`, or an imported tree) and returns a
state dict of fp32 tensors for `load_state_dict(..., strict=True)`;
`lora_from_jax` and `trainable_from_jax` carry LoRA adapters and the
trainer's whole bundle (lora/surgery.py, train/sd_finetune.py);
`unet2d_from_jax` and `simple_unet_from_jax` the scratch path's models
(models/unet2d.py, models/simple_unet.py).
`jax_module_path` is the inverse for module names: the port's module
`down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.0` is the
reference's `down_0_attn_0/transformer_blocks_0/attn1/to_out`, whose last
component is the name the reference's LoRA targets match.

The classifier (models/efficientnet.py) names its parameters by the
reference's tree, so `efficientnet_from_jax` is a rename of leaves and
the same transposes (a depthwise kernel (k, k, 1, C) → (C, 1, k, k)), with
the batch statistics `mean`/`var` → `running_mean`/`running_var`.
`efficientnet_from_torchvision` is the twin of the reference's
`import_torch_state_dict` (polyp_tpu/models/efficientnet.py:230): a
torchvision `efficientnet_bN` state dict → the port's backbone.

`load_sd_checkpoint` reads a local diffusers SD-v1-4 directory (the twin
of the reference's, importers.py:315-330): the port's keys are diffusers'
keys, so the state dicts load as they are, from `.safetensors` (read by
utils/checkpoint.py, without the safetensors package) or torch `.bin`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from polyp_tpu_torch.utils.checkpoint import read_safetensors

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


def unet2d_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """polyp_tpu scratch UNet2D params → the port's UNet2D state dict
    (models/unet2d.py names its modules by the same rules:
    `down_4_attn_0/attn/attention/to_q` → `down_blocks.4.attentions.0.
    attn.to_q`, `cross_attn/to_out` → `cross_attn.to_out.0`)."""
    return _convert(_params(params), _BLOCK_RULES)


def simple_unet_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """polyp_tpu SimpleUNet params → the port's SimpleUNet state dict: the
    flax module names are kept (`down_0/conv1` → `down_0.conv1`)."""
    return _convert(_params(params), [])


def vae_decoder_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """polyp_tpu AutoencoderKL params → the port's AutoencoderKL state dict:
    `decoder.*` and `post_quant_conv.*` (the encoder side is dropped)."""
    p = _params(params)
    keep = {k: p[k] for k in ("decoder", "post_quant_conv")}
    return _convert(keep, _BLOCK_RULES)


def vae_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """polyp_tpu AutoencoderKL params → the port's AutoencoderKL state dict
    (encoder, quant_conv, decoder, post_quant_conv)."""
    return _convert(_params(params), _BLOCK_RULES)


def _module_name(path: str, rules: list[Rule]) -> str:
    """A reference module path ('/'-joined) → the port's module name."""
    path += "/"
    for pat, repl in rules:
        path = re.sub(pat, repl, path)
    return path.rstrip("/").replace("/", ".")


def scales_from_jax(scales: dict[str, Any]) -> dict[str, Any]:
    """polyp_tpu calibrated quantization scales ({flax layer path: float or
    per-timestep table}, e.g. `down_0_attn_0/transformer_blocks_0/ff/
    ff_net_0_proj`) → the port's keys (the module names, e.g.
    `down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj`), by
    the same rules as the weights, so both packages can run with one set of
    scales."""
    out: dict[str, Any] = {}
    for path, val in scales.items():
        key = _module_name(path, _BLOCK_RULES)
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


# port module name → the reference's module path, the inverse of
# _BLOCK_RULES and _CLIP_RULES on module names ('.'-joined, then '/')
_INVERSE_BLOCK_RULES: list[Rule] = [
    (r"(^|\.)(down|up)_blocks\.(\d+)\.resnets\.(\d+)(?=\.|$)",
     r"\1\2_\3_res_\4"),
    (r"(^|\.)(down|up)_blocks\.(\d+)\.attentions\.(\d+)(?=\.|$)",
     r"\1\2_\3_attn_\4"),
    (r"(^|\.)down_blocks\.(\d+)\.downsamplers\.0(?=\.|$)",
     r"\1down_\2_downsample"),
    (r"(^|\.)up_blocks\.(\d+)\.upsamplers\.0(?=\.|$)",
     r"\1up_\2_upsample"),
    (r"(^|\.)mid_block\.resnets\.(\d+)(?=\.|$)", r"\1mid_res_\2"),
    (r"(^|\.)mid_block\.attentions\.0(?=\.|$)", r"\1mid_attn"),
    (r"(^|\.)transformer_blocks\.(\d+)(?=\.|$)",
     r"\1transformer_blocks_\2"),
    (r"(^|\.)ff\.net\.0\.proj(?=\.|$)", r"\1ff.ff_net_0_proj"),
    (r"(^|\.)ff\.net\.2(?=\.|$)", r"\1ff.ff_net_2"),
    (r"(^|\.)to_out\.0(?=\.|$)", r"\1to_out"),
]

_INVERSE_CLIP_RULES: list[Rule] = [
    (r"^text_model\.encoder\.layers\.(\d+)\.mlp\.", r"layer_\1."),
    (r"^text_model\.encoder\.layers\.(\d+)(?=\.|$)", r"layer_\1"),
    (r"^text_model\.final_layer_norm", r"final_layer_norm"),
]


def jax_module_path(name: str) -> str:
    """The reference's '/'-joined path of the port's module `name` (of the
    UNet or of CLIPTextModel: each rule set leaves the other's names as
    they are)."""
    for pat, repl in _INVERSE_CLIP_RULES + _INVERSE_BLOCK_RULES:
        name = re.sub(pat, repl, name)
    return name.replace(".", "/")


def lora_from_jax(adapter: Any) -> dict:
    """A polyp_tpu LoRA adapter tree of the UNet or CLIP ({..., module:
    {"lora_A": [in, r], "lora_B": [r, out]}}) → the port's adapter
    {module name: {"lora_A", "lora_B"}}, factors as they are (fp32
    copies)."""
    rules = _CLIP_RULES + _BLOCK_RULES
    out: dict[str, dict[str, torch.Tensor]] = {}
    for path, val in _flatten(adapter).items():
        module, leaf = path.rsplit("/", 1)
        name = _module_name(module, rules)
        out.setdefault(name, {})[leaf] = torch.from_numpy(
            np.array(val, np.float32))
    return out


def trainable_from_jax(bundle: Any) -> dict:
    """polyp_tpu's trainable bundle (train/sd_finetune.py::init_trainable:
    `unet_lora`, `text_lora`, `proj`, `special_rows`, `unfrozen`) → the
    port's: adapters by `lora_from_jax`, `unfrozen` as UNet state-dict
    entries (kernels in torch layouts), `proj` ({"kernel": [4, 768],
    "bias"}) and `special_rows` as they are."""
    out: dict[str, Any] = {}
    for key, val in bundle.items():
        if key in ("unet_lora", "text_lora"):
            out[key] = lora_from_jax(val)
        elif key == "unfrozen":
            out[key] = unet_from_jax(val)
        elif key == "proj":
            out[key] = {k: torch.from_numpy(np.array(v, np.float32))
                        for k, v in val.items()}
        elif key == "special_rows":
            out[key] = torch.from_numpy(np.array(val, np.float32))
        else:
            raise KeyError(f"unknown trainable entry {key!r}")
    return out


_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def efficientnet_from_jax(params: Any, batch_stats: Any | None = None
                          ) -> dict[str, torch.Tensor]:
    """polyp_tpu's PolypClassifier (or EfficientNet) `params` and
    `batch_stats` trees → the port's state dict of the same module."""
    out = _convert(_params(params), [])
    if batch_stats is not None:
        for path, val in _flatten(batch_stats).items():
            *parents, leaf = path.split("/")
            out[".".join([*parents, _BN_STATS[leaf]])] = torch.from_numpy(
                np.array(val, np.float32))
    return out


def efficientnet_from_torchvision(state_dict: dict[str, Any],
                                  variant: str = "b0"
                                  ) -> dict[str, torch.Tensor]:
    """A torchvision `efficientnet_bN` state dict → the port's backbone
    state dict (`PolypClassifier.backbone`, models/efficientnet.py). The
    classifier head is not imported: the reference replaces it. Every
    other key must be consumed (`num_batches_tracked` aside), or KeyError.

    torchvision's layout: features.0 the stem; features.{1..7}.{i}.block.
    {j}, j = 0 the expand conv (absent where the expand ratio is 1), then
    the depthwise conv, the squeeze-excite (fc1, fc2) and the projection;
    features.8 the head conv."""
    from polyp_tpu_torch.models.efficientnet import (
        B0_STAGES, VARIANTS, _round_repeats)

    out: dict[str, torch.Tensor] = {}
    used: set[str] = set()

    def take(src: str, dst: str) -> None:
        used.add(src)
        out[dst] = torch.as_tensor(np.array(state_dict[src], np.float32))

    def convbn(src: str, dst: str) -> None:
        take(f"{src}.0.weight", f"{dst}.conv.weight")
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            take(f"{src}.1.{leaf}", f"{dst}.bn.{leaf}")

    convbn("features.0", "stem")
    _, depth, _ = VARIANTS[variant]
    for stage_i, (expand, _, repeats, _, _) in enumerate(B0_STAGES):
        for i in range(_round_repeats(repeats, depth)):
            name = f"stage{stage_i + 1}_block{i}"
            src = f"features.{stage_i + 1}.{i}.block"
            j = 0
            if expand != 1:
                convbn(f"{src}.{j}", f"{name}.expand")
                j += 1
            convbn(f"{src}.{j}", f"{name}.depthwise")
            j += 1
            for fc in ("fc1", "fc2"):
                for leaf in ("weight", "bias"):
                    take(f"{src}.{j}.{fc}.{leaf}", f"{name}.se.{fc}.{leaf}")
            convbn(f"{src}.{j + 1}", f"{name}.project")
    convbn("features.8", "head")
    leftover = {k for k in state_dict
                if k not in used and not k.startswith("classifier.")
                and not k.endswith("num_batches_tracked")}
    if leftover:
        raise KeyError("unconsumed torchvision keys (first 10): "
                       + ", ".join(sorted(leftover)[:10]))
    return out


# keys some transformers checkpoints carry beside the model's parameters
_DROPPED_TEXT_KEYS = ("text_model.embeddings.position_ids",
                      "text_projection.weight")


def load_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A `.safetensors` or torch `.bin` state dict, as CPU tensors."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def find_weights(model_dir: str | Path, stem: str) -> Path:
    """`{stem}.safetensors` or `{stem}.bin` in a checkpoint directory."""
    model_dir = Path(model_dir)
    for suffix in (".safetensors", ".bin"):
        path = model_dir / f"{stem}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no {stem}.(safetensors|bin) in {model_dir}")


SD_WEIGHT_FILES = {"unet": ("unet", "diffusion_pytorch_model"),
                   "vae": ("vae", "diffusion_pytorch_model"),
                   "text": ("text_encoder", "model")}


def load_sd_checkpoint(model_dir: str | Path) -> dict[str, dict]:
    """{"unet", "vae", "text"} state dicts from a local diffusers SD-v1-4
    layout (`unet/diffusion_pytorch_model.*`, `vae/...`,
    `text_encoder/model.*`)."""
    out = {}
    for part, (sub, stem) in SD_WEIGHT_FILES.items():
        sd = load_state_dict(find_weights(Path(model_dir) / sub, stem))
        if part == "text":
            sd = {k: v for k, v in sd.items() if k not in _DROPPED_TEXT_KEYS}
        out[part] = sd
    return out
