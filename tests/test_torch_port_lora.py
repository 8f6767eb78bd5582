"""LoRA surgery, trainability masks, checkpoints and checkpoint import in
polyp_tpu_torch against polyp_tpu on the CPU.

* The targeted layers of every preset (configs.LORA_MODULE_PRESETS) at
  SD-v1-4 width, UNet and CLIP, are the reference's (shapes only: JAX
  builds its trees under `jax.eval_shape`), with the same parameter count.
* `merge_lora` with the same factors and dropout masks gives the
  reference's merged kernels, and merges in fp32 before the one rounding
  to a bf16 module's dtype.
* `load_sd_stack(pretrained_dir)` on a tiny diffusers directory written
  here (`.safetensors`, read by the port's own reader, or `.bin`) gives the
  outputs of polyp_tpu's `load_sd_checkpoint` on the same directory.

`jax_tiny_stack` / `port_tiny_stack` (the reference's tiny UNet, VAE and
CLIP with seeded weights, and the port's modules loaded from them) serve
tests/test_torch_port_train*.py too.
"""

from __future__ import annotations

import argparse
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.lora import partition as jpart
from polyp_tpu.lora import surgery as jsurg
from polyp_tpu.models import importers as jimp
from polyp_tpu.models.clip_text import TINY_TEXT_CONFIG as J_TINY_TEXT
from polyp_tpu.models.clip_text import CLIPTextModel as JCLIP
from polyp_tpu.models.unet_condition import sd14_unet as j_sd14_unet
from polyp_tpu.models.unet_condition import tiny_condition_unet as j_tiny_unet
from polyp_tpu.models.vae import tiny_vae as j_tiny_vae
from polyp_tpu.utils.rng import _stream_hash
from polyp_tpu_torch import serve as tserve
from polyp_tpu_torch.cli.common import SDStack, load_sd_stack
from polyp_tpu_torch.configs import LORA_MODULE_PRESETS
from polyp_tpu_torch.lora import partition as tpart
from polyp_tpu_torch.lora import surgery as tsurg
from polyp_tpu_torch.models import (
    SD14_TEXT_CONFIG,
    TINY_TEXT_CONFIG,
    CLIPTextModel,
    HashTokenizer,
    sd14_unet,
    tiny_condition_unet,
    tiny_vae,
)
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.utils import checkpoint as tckpt
from test_torch_port_models import _nchw, _normal, _to_nhwc

L = J_TINY_TEXT.max_length


def _init_like(shapes, seed: int):
    """Values for a flax parameter tree of `shapes` without running
    `init`: kernels N(0, 1/fan_in), embeddings N(0, 0.02²), norm scales
    1 + N(0, 0.05²), biases N(0, 0.05²) (numpy, fp32)."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        shape = node.shape
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.05 * noise
        if name == "bias":
            return 0.05 * noise
        return 0.02 * noise  # token / position embeddings

    return walk(shapes, "")


@functools.lru_cache(maxsize=None)
def jax_tiny_stack():
    """(unet, unet params, vae, vae params, text, text params) of the
    reference's tiny stack with seeded weights (numpy arrays; shapes from
    `jax.eval_shape` of each module's init)."""
    k = jax.random.PRNGKey(0)
    unet, vae, text = j_tiny_unet(), j_tiny_vae(), JCLIP(J_TINY_TEXT)
    shapes = [
        jax.eval_shape(unet.init, k, jnp.zeros((1, 4, 4, 4)),
                       jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, L, J_TINY_TEXT.width)))["params"],
        jax.eval_shape(vae.init, k, jnp.zeros((1, 32, 32, 3)), k)["params"],
        jax.eval_shape(text.init, k, jnp.zeros((1, L), jnp.int32))["params"]]
    up, vp, tp = (_init_like(s, seed) for seed, s in enumerate(shapes, 1))
    return unet, up, vae, vp, text, tp


def port_tiny_stack() -> SDStack:
    """The port's tiny stack (fp32, CPU) with the reference's weights."""
    _, up, _, vp, _, tp = jax_tiny_stack()
    unet, vae, text = (tiny_condition_unet(), tiny_vae(),
                       CLIPTextModel(TINY_TEXT_CONFIG))
    unet.load_state_dict(timp.unet_from_jax(up), strict=True)
    vae.load_state_dict(timp.vae_from_jax(vp), strict=True)
    text.load_state_dict(timp.clip_text_from_jax(tp), strict=True)
    return SDStack(unet.eval(), vae.eval(), text.eval(),
                   HashTokenizer(vocab_size=TINY_TEXT_CONFIG.vocab_size,
                                 max_length=L))


def jax_keep_mask(rng, name: str, rows: int, keep: float) -> np.ndarray:
    """The reference's dropout keep mask of the port's module `name`:
    `rng` folded with the stream hash of each component of the module's
    reference path, as apply_lora_to_kernels walks the tree."""
    for part in timp.jax_module_path(name).split("/"):
        rng = jax.random.fold_in(rng, _stream_hash(part))
    return np.asarray(jax.random.bernoulli(rng, keep, (rows, 1)),
                      np.float32)


def _module_paths(tree, prefix=()):
    """'/'-joined paths of the dicts that hold a `kernel` leaf."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            if "kernel" in v:
                out.append("/".join(prefix + (k,)))
            out += _module_paths(v, prefix + (k,))
    return out


# ---------------------------------------------------------------------------
# which layers a preset targets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sd14_shapes():
    unet = j_sd14_unet(dtype=jnp.float32)
    text = JCLIP()
    k = jax.random.PRNGKey(0)
    up = jax.eval_shape(unet.init, k, jnp.zeros((1, 8, 8, 4)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, 77, 768)))["params"]
    tp = jax.eval_shape(text.init, k, jnp.zeros((1, 77), jnp.int32))["params"]
    return up, tp


@pytest.mark.parametrize("preset", sorted(LORA_MODULE_PRESETS))
def test_preset_targets_the_reference_layers_at_full_width(preset):
    """Every preset picks the same layers of the SD-v1-4 UNet and CLIP
    text encoder in both packages, with the same LoRA parameter count."""
    up, tp = _sd14_shapes()
    targets = LORA_MODULE_PRESETS[preset]
    cfg = jsurg.LoRAConfig(8, None, 0.0, targets)
    for jparams, module in ((up, sd14_unet(device="meta")),
                            (tp, CLIPTextModel(SD14_TEXT_CONFIG,
                                               device="meta"))):
        adapter = jax.eval_shape(
            lambda p: jsurg.init_lora(p, cfg, jax.random.PRNGKey(0)),
            jparams)
        want = {timp._module_name(p.replace(".", "/"), timp._CLIP_RULES
                                  + timp._BLOCK_RULES)
                for p in jsurg.lorarized_layers(adapter)}
        layers = tsurg.target_layers(module, targets)
        assert set(layers) == want
        count = sum(8 * sum(tsurg._in_out(m)) for m in layers.values())
        assert count == jsurg.count_lora_params(adapter)
    if preset == "attention":
        # the fp32 base kernels the trainer keeps: 6C² + 1536C a
        # transformer block, over 5×320, 5×640 and 6×1280 channels
        kernels = sum(m.weight.numel() for m in tsurg.target_layers(
            sd14_unet(device="meta"), targets).values())
        widths = [320] * 5 + [640] * 5 + [1280] * 6
        assert kernels == sum(6 * c * c + 1536 * c for c in widths) \
            == 93_511_680


def test_jax_module_path_inverts_the_importer_rules():
    """Every Linear / Conv2d of the tiny UNet and CLIP maps to a module of
    the reference's tree and back to its own name."""
    unet, up, _, _, text, tp = jax_tiny_stack()
    stack = port_tiny_stack()
    for module, tree in ((stack.unet, up), (stack.text, tp)):
        paths = set(_module_paths(tree))
        names = [n for n, m in module.named_modules()
                 if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
        assert len(names) == len(paths)
        for name in names:
            path = timp.jax_module_path(name)
            assert path in paths, name
            assert timp._module_name(
                path, timp._CLIP_RULES + timp._BLOCK_RULES) == name


def test_init_lora_starts_as_a_no_op():
    stack = port_tiny_stack()
    cfg = tsurg.LoRAConfig(4, None, 0.0, LORA_MODULE_PRESETS["attention_mlp"])
    adapter = tsurg.init_lora(stack.unet, cfg,
                              torch.Generator().manual_seed(0))
    assert tsurg.lorarized_layers(adapter) == sorted(adapter)
    for name, f in adapter.items():
        fan_in, fan_out = tsurg._in_out(stack.unet.get_submodule(name))
        assert f["lora_A"].shape == (fan_in, 4)
        assert f["lora_B"].shape == (4, fan_out) and not f["lora_B"].any()
    kernels = stack.fp32_params("unet", [f"{n}.weight" for n in adapter])
    for key, w in tsurg.merge_lora(kernels, adapter, cfg).items():
        assert torch.equal(w, stack.unet.get_parameter(key))


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset,dropout", [("attention", 0.0),
                                            ("attention_mlp", 0.3),
                                            ("text_encoder", 0.3)])
def test_merge_lora_matches_jax(preset, dropout):
    """The same A, B and keep masks give the reference's merged kernels
    (dense δᵀ, 1×1-conv δ as [out, in, 1, 1]); 1e-6 of the kernel scale:
    one fp32 product and sum."""
    unet, up, _, _, text, tp = jax_tiny_stack()
    jparams = tp if preset == "text_encoder" else up
    cfg = jsurg.LoRAConfig(4, 8.0, dropout, LORA_MODULE_PRESETS[preset])
    rng = np.random.default_rng(40)
    adapter = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32), jsurg.init_lora(jparams, cfg, jax.random.PRNGKey(1)))
    drop_rng = jax.random.PRNGKey(2)
    want = jsurg.merge_lora(jparams, adapter, cfg, dropout_rng=drop_rng,
                            train=dropout > 0)
    convert = (timp.clip_text_from_jax if preset == "text_encoder"
               else timp.unet_from_jax)
    want = convert(jax.tree_util.tree_map(np.asarray, want))
    base = convert(jparams)
    tadapter = timp.lora_from_jax(adapter)
    masks = ({n: torch.from_numpy(jax_keep_mask(
        drop_rng, n, f["lora_A"].shape[0], 1 - dropout))
        for n, f in tadapter.items()} if dropout else None)
    tcfg = tsurg.LoRAConfig(4, 8.0, dropout, cfg.target_modules)
    got = tsurg.merge_lora({f"{n}.weight": base[f"{n}.weight"]
                            for n in tadapter}, tadapter, tcfg, masks)
    assert set(got) == {k for k in want if not torch.equal(want[k], base[k])}
    for key, w in got.items():
        np.testing.assert_allclose(w.numpy(), want[key].numpy(), rtol=0,
                                   atol=1e-6 * base[key].abs().max().item())
    if dropout:
        assert any(0 < m.sum() < m.numel() for m in masks.values())


def test_merge_rounds_once_from_fp32():
    """A δ below half a bf16 ulp of W still moves the bf16 kernel where
    W + δ crosses a rounding midpoint: the port's merge is
    bf16(W32 + δ), as the reference's (kernel + δ).astype(bf16) in use,
    never bf16(bf16(W) + δ), which drops it."""
    out_f, in_f, r = 64, 48, 4
    # positive W in [0.05, 0.2], each just below a bf16 rounding midpoint
    w16 = torch.from_numpy(0.05 + np.abs(_normal(41, (out_f, in_f), 0.04))
                           ).to(torch.bfloat16).float()
    ulp = 2.0 ** (torch.floor(torch.log2(w16)) - 7)
    a = torch.full((in_f, r), 1.0)
    b = torch.full((r, out_f), 2e-7)
    delta = (a @ b).T  # 8e-7 everywhere
    w32 = w16 + 0.5 * ulp - delta / 2
    adapter = {"layer": {"lora_A": a, "lora_B": b}}
    cfg = tsurg.LoRAConfig(r, None, 0.0, ("layer",))
    assert torch.equal(w32.to(torch.bfloat16).float(), w16)
    assert delta.abs().max() < 0.5 * ulp.min()  # below half an ulp of W
    got = tsurg.merge_lora({"layer.weight": w32}, adapter, cfg,
                           dtype=torch.bfloat16)["layer.weight"]
    want = jnp.asarray((w32 + delta).numpy()).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    naive = (w32.to(torch.bfloat16) + delta.to(torch.bfloat16))
    assert torch.equal(naive, w32.to(torch.bfloat16))  # δ swallowed
    assert (got != naive).float().mean() > 0.5


def test_merged_module_shares_all_but_the_merged_weights():
    stack = port_tiny_stack()
    before = {k: v.clone() for k, v in stack.unet.state_dict().items()}
    key = "mid_block.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    new = stack.unet.get_parameter(key).detach() + 1.0
    copy = tsurg.merged_module(stack.unet, {key: new})
    assert copy is not stack.unet
    assert torch.equal(copy.get_parameter(key), new)
    for name, p in copy.named_parameters():
        if name != key:
            assert p is stack.unet.get_parameter(name), name
    for k, v in stack.unet.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# trainability masks
# ---------------------------------------------------------------------------

def test_partition_matches_jax():
    """`--unfreeze_layers`' substrings pick the same base parameters (the
    port's names are the reference's paths through the importer rules),
    with the same (trainable, total) counts; overlay swaps in the subset
    and leaves the base alone."""
    _, up, _, _, _, _ = jax_tiny_stack()
    stack = port_tiny_stack()
    subs = ["to_q", "to_k", "to_v", "to_out"]
    jmask = jpart.path_mask(up, subs)
    jsub = jpart.extract_by_mask(up, jmask)
    params = {n: p.detach() for n, p in stack.unet.named_parameters()}
    tmask = tpart.path_mask(params, subs)
    tsub = tpart.extract_by_mask(params, tmask)
    assert set(tsub) == set(timp.unet_from_jax(jsub))
    assert tpart.trainable_count(params, tmask) == jpart.trainable_count(
        up, jmask)
    new = {k: v + 1 for k, v in tsub.items()}
    merged = tpart.overlay_params(params, new)
    assert all(merged[k] is new[k] for k in new)
    assert all(merged[k] is params[k] for k in params if k not in new)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_save_and_load_lora_round_trip(tmp_path):
    stack = port_tiny_stack()
    cfg = tsurg.LoRAConfig(4, None, 0.0, LORA_MODULE_PRESETS["attention"])
    adapter = tsurg.init_lora(stack.unet, cfg,
                              torch.Generator().manual_seed(3))
    bundle = {"unet_lora": adapter, "special_rows": torch.randn(1, 32),
              "special_ids": torch.tensor([511])}
    tsurg.save_lora(tmp_path / "lora_AD.pt", bundle)
    back = tsurg.load_lora(tmp_path / "lora_AD.pt")
    like = tckpt.tree_map(lambda t: t.to(torch.float64), bundle)
    typed = tsurg.load_lora(tmp_path / "lora_AD.pt", like)
    for tree in (back, typed):
        assert list(tree["unet_lora"]) == list(adapter)  # order kept
    for name, f in adapter.items():
        for k, v in f.items():
            assert torch.equal(back["unet_lora"][name][k], v)
            assert typed["unet_lora"][name][k].dtype == torch.float64
    assert tsurg.count_lora_params(back["unet_lora"]) == \
        tsurg.count_lora_params(adapter)
    with pytest.raises(KeyError):
        tckpt.load_pytree(tmp_path / "lora_AD.pt", {"unet_lora": {}})


SAFETENSORS_CASES = {
    "f32": torch.randn(3, 5),
    "bf16": torch.randn(4, 2).to(torch.bfloat16),
    "f16": torch.randn(7).to(torch.float16),
    "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
    "u8": torch.arange(10, dtype=torch.uint8),
    "flag": torch.tensor([True, False, True]),
    "empty": torch.zeros(0, 4),
    "scalar": torch.tensor(2.5),
}


def write_safetensors(path: Path, tensors: dict[str, torch.Tensor]) -> None:
    """A minimal writer of the format (for files the tests make)."""
    names = {v: k for k, v in tckpt.SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for key, t in tensors.items():
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    path.write_bytes(len(head).to_bytes(8, "little") + head + b"".join(blobs))


def test_read_safetensors_matches_the_package(tmp_path):
    """The port's reader against the safetensors package (here; the card's
    machine has none): every dtype, an empty and a 0-d tensor, a subset."""
    st = pytest.importorskip("safetensors.torch")
    st.save_file(SAFETENSORS_CASES, tmp_path / "a.safetensors",
                 metadata={"format": "pt"})
    write_safetensors(tmp_path / "b.safetensors", SAFETENSORS_CASES)
    for name in ("a", "b"):
        path = tmp_path / f"{name}.safetensors"
        got = tckpt.read_safetensors(path)
        want = st.load_file(path)
        assert set(got) == set(want) == set(SAFETENSORS_CASES)
        for key, val in want.items():
            assert got[key].dtype == val.dtype and torch.equal(got[key], val)
    sub = tckpt.read_safetensors(tmp_path / "a.safetensors", ["bf16"])
    assert list(sub) == ["bf16"]


def write_diffusers_dir(root: Path, fmt: str) -> Path:
    """A tiny diffusers layout with the reference's tiny weights:
    unet/, vae/, text_encoder/ (with transformers' `position_ids` extra)
    in `fmt` ("safetensors" or "bin"), and an empty tokenizer/."""
    _, up, _, vp, _, tp = jax_tiny_stack()
    text = timp.clip_text_from_jax(tp)
    text["text_model.embeddings.position_ids"] = torch.arange(L)[None]
    parts = {"unet/diffusion_pytorch_model": timp.unet_from_jax(up),
             "vae/diffusion_pytorch_model": timp.vae_from_jax(vp),
             "text_encoder/model": text}
    for stem, sd in parts.items():
        path = root / f"{stem}.{fmt}"
        path.parent.mkdir(parents=True, exist_ok=True)
        if fmt == "safetensors":
            write_safetensors(path, sd)
        else:
            torch.save(sd, path)
    (root / "tokenizer").mkdir()
    return root


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_sd_stack_imports_a_diffusers_dir_as_jax_does(tmp_path, fmt):
    """polyp_tpu's load_sd_checkpoint and the port's load_sd_stack on the
    same directory: the UNet, VAE (encode and decode) and CLIP outputs
    agree within 1e-3 (the blocks' tolerance, test_torch_port_models);
    a bf16 stack's fp32_params are the file's fp32 values."""
    root = write_diffusers_dir(tmp_path / "sd", fmt)
    unet, up, vae, vp, text, tp = jax_tiny_stack()
    loaded = jimp.load_sd_checkpoint(root, unet_like=up, vae_like=vp,
                                     text_like=tp)
    stack = load_sd_stack(str(root), dtype=torch.float32, tiny=True,
                          device="cpu")
    assert stack.pretrained_dir == str(root)
    x, t = _normal(42, (2, 4, 4, 4)), np.array([10, 900], np.int32)
    ctx, img = _normal(43, (2, L, 32)), _normal(44, (2, 32, 32, 3))
    ids = np.random.default_rng(45).integers(0, 512, (2, L)).astype(np.int32)
    with torch.no_grad():
        pairs = [
            (stack.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx)),
             unet.apply({"params": loaded["unet"]}, jnp.asarray(x),
                        jnp.asarray(t), jnp.asarray(ctx))),
            (stack.vae.encode_moments(_nchw(img)),
             vae.apply({"params": loaded["vae"]}, jnp.asarray(img),
                       method=vae.encode_moments)),
            (stack.vae.decode(_nchw(x)),
             vae.apply({"params": loaded["vae"]}, jnp.asarray(x),
                       method=vae.decode))]
        got_text = stack.text(torch.from_numpy(ids).long())
    for got, want in pairs:
        np.testing.assert_allclose(_to_nhwc(got), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)
    want_text = text.apply({"params": loaded["text"]}, jnp.asarray(ids))
    np.testing.assert_allclose(got_text.numpy(), np.asarray(want_text),
                               rtol=1e-3, atol=1e-3)
    low = load_sd_stack(str(root), dtype=torch.bfloat16, tiny=True,
                        device="cpu")
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    w32 = low.fp32_params("unet", [name])[name]
    assert w32.dtype == torch.float32
    assert torch.equal(w32, timp.unet_from_jax(up)[name])
    assert torch.equal(w32.to(torch.bfloat16), low.unet.get_parameter(name))


def test_fp32_params_of_a_seeded_stack_replay_its_draws():
    """A bf16 random-init stack's fp32 copies are the fp32 stack's values
    from the same seed (bit for bit), and round to its own parameters."""
    low = load_sd_stack(None, dtype=torch.bfloat16, tiny=True, device="cpu",
                        seed=4)
    full = load_sd_stack(None, dtype=torch.float32, tiny=True, device="cpu",
                         seed=4)
    for part in ("unet", "vae", "text"):
        names = [n for n, p in getattr(low, part).named_parameters()
                 if p.dtype == torch.bfloat16][:7]
        got = low.fp32_params(part, names)
        for n in names:
            want = getattr(full, part).get_parameter(n)
            assert torch.equal(got[n], want), (part, n)
            assert got[n].data_ptr() != want.data_ptr()
            assert torch.equal(got[n].to(torch.bfloat16),
                               getattr(low, part).get_parameter(n))


def test_serve_takes_a_pretrained_dir(tmp_path):
    """polyp-serve-torch's --pretrained-dir builds its sampler on the
    imported weights."""
    root = write_diffusers_dir(tmp_path / "sd", "safetensors")
    args = argparse.Namespace(
        pretrained_dir=str(root), tiny=True, device="cpu", image_size=32,
        steps=2, quantize=None, quant_fp_head=0, quant_fp_tail=0,
        vae_decoder="full", tiny_decoder_dir=None)
    sampler = tserve.sampler_from_args(args)
    _, up, _, _, _, _ = jax_tiny_stack()
    want = timp.unet_from_jax(up)
    for key, val in sampler.unet.state_dict().items():
        assert torch.equal(val, want[key].to(val.dtype)), key
