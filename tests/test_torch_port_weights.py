"""polyp_tpu_torch's weight layout: diffusers/transformers keys, the JAX →
port weight carrier, and the package's independence from JAX.

* Round trip: a fabricated diffusers state dict goes through polyp_tpu's
  importer (diffusers → flax) and back through the port's `*_from_jax`,
  and must come back key for key and bit for bit; the port's modules load
  it natively with strict=True.
* The full-size SD-v1-4 modules, built on the meta device, must have
  exactly the manifests' keys and shapes (tests/fixtures/manifests).
* polyp_tpu_torch imports no jax, flax, optax, orbax, polyp_tpu,
  safetensors (it reads `.safetensors` itself), pandas, sklearn or
  torchvision, and no matplotlib or mlflow at module level (they are
  imported where a plot is drawn or an mlflow tracker built): by an AST
  scan of its sources and by importing every module in a fresh
  interpreter.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from polyp_tpu.models import importers as jimp
from polyp_tpu_torch.models import (
    TINY_TEXT_CONFIG,
    AutoencoderKL,
    CLIPTextModel,
    sd14_unet,
    tiny_condition_unet,
    tiny_vae,
)
from polyp_tpu_torch.models import importers as timp
from test_torch_block_goldens import (
    Fab,
    fabricate_tiny_unet_sd,
    fabricate_tiny_vae_sd,
)
from _torch_threads import _one_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
MANIFESTS = ROOT / "tests" / "fixtures" / "manifests"
# the card's machine has no JAX, safetensors, pandas, sklearn or
# torchvision package
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "polyp_tpu",
          "safetensors", "pandas", "sklearn", "torchvision"}
# ... nor matplotlib or mlflow, which the port imports only inside the
# functions that need them
LAZY = {"matplotlib", "mlflow"}
DECODER_KEYS = ("decoder.", "post_quant_conv.")
ENCODER_KEYS = ("encoder.", "quant_conv.")


def _manifest(name: str) -> dict[str, list[int]]:
    return json.loads((MANIFESTS / f"{name}.json").read_text())


def _save(sd: dict[str, np.ndarray], path: Path) -> Path:
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def _tensors(sd: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _assert_same(got: dict[str, torch.Tensor], want: dict[str, np.ndarray]):
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)


def fabricate_tiny_clip_sd() -> dict[str, np.ndarray]:
    """transformers-layout dict for TINY_TEXT_CONFIG (width 32, 2 layers)."""
    fab = Fab(14)
    c, cfg = 32, TINY_TEXT_CONFIG
    emb = "text_model.embeddings"
    fab.sd[f"{emb}.token_embedding.weight"] = fab._w((cfg.vocab_size, c))
    fab.sd[f"{emb}.position_embedding.weight"] = fab._w((cfg.max_length, c))
    for i in range(cfg.layers):
        p = f"text_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            fab.linear(f"{p}.self_attn.{proj}", c, c)
        fab.norm(f"{p}.layer_norm1", c)
        fab.linear(f"{p}.mlp.fc1", 4 * c, c)
        fab.linear(f"{p}.mlp.fc2", c, 4 * c)
        fab.norm(f"{p}.layer_norm2", c)
    fab.norm("text_model.final_layer_norm", c)
    return fab.sd


def test_unet_round_trip_through_jax_importer(tmp_path):
    sd = fabricate_tiny_unet_sd()
    tree = jimp.import_unet_condition(_save(sd, tmp_path / "unet.bin"))
    _assert_same(timp.unet_from_jax(tree), sd)
    tiny_condition_unet().load_state_dict(_tensors(sd), strict=True)


def test_vae_decoder_round_trip_through_jax_importer(tmp_path):
    sd = fabricate_tiny_vae_sd()
    tree = jimp.import_vae(_save(sd, tmp_path / "vae.bin"))
    want = {k: v for k, v in sd.items() if k.startswith(DECODER_KEYS)}
    _assert_same(timp.vae_decoder_from_jax(tree), want)
    # the decoder's keys are the VAE's less its encoder side
    missing, unexpected = tiny_vae().load_state_dict(_tensors(want),
                                                     strict=False)
    assert not unexpected
    assert missing and all(k.startswith(ENCODER_KEYS) for k in missing)


def test_vae_round_trip_through_jax_importer(tmp_path):
    """The whole VAE (encoder, quant_conv, decoder, post_quant_conv)."""
    sd = fabricate_tiny_vae_sd()
    tree = jimp.import_vae(_save(sd, tmp_path / "vae.bin"))
    _assert_same(timp.vae_from_jax(tree), sd)
    tiny_vae().load_state_dict(_tensors(sd), strict=True)


def test_clip_round_trip_through_jax_importer(tmp_path):
    sd = fabricate_tiny_clip_sd()
    tree = jimp.import_clip_text(_save(sd, tmp_path / "text.bin"))
    _assert_same(timp.clip_text_from_jax(tree), sd)
    CLIPTextModel(TINY_TEXT_CONFIG).load_state_dict(_tensors(sd), strict=True)


def _placeholders(manifest: dict[str, list[int]]) -> dict[str, np.ndarray]:
    # keys only: one element per tensor keeps the full-size check cheap
    return {k: np.zeros((1,) * len(s), np.float32) for k, s in manifest.items()}


@pytest.mark.parametrize("name,rules,back,prefixes", [
    ("sd14_unet", "unet_condition_rules", "unet_from_jax", None),
    ("sd14_vae", "vae_rules", "vae_decoder_from_jax", DECODER_KEYS),
    ("sd14_text_encoder", "clip_text_rules", "clip_text_from_jax", None),
    ("sd14_vae", "vae_rules", "vae_from_jax", None),
])
def test_full_size_keys_round_trip(name, rules, back, prefixes):
    """Every full-size checkpoint key survives diffusers → flax → port."""
    manifest = _manifest(name)
    flat = jimp.apply_rules(_placeholders(manifest), getattr(jimp, rules)())
    tree = jimp.to_pytree({k: v for k, v in flat.items()
                           if not k.startswith("__drop")})
    want = {k for k in manifest if prefixes is None or k.startswith(prefixes)}
    assert set(getattr(timp, back)(tree)) == want


def _shapes(module: torch.nn.Module) -> dict[str, list[int]]:
    return {k: list(v.shape) for k, v in module.state_dict().items()}


def test_sd14_unet_matches_manifest_and_param_count():
    unet = sd14_unet(device="meta")
    assert _shapes(unet) == _manifest("sd14_unet")
    assert sum(p.numel() for p in unet.parameters()) == 859_520_964


def test_sd14_vae_decoder_matches_manifest():
    want = {k: v for k, v in _manifest("sd14_vae").items()
            if k.startswith(DECODER_KEYS)}
    got = _shapes(AutoencoderKL(device="meta"))
    assert {k: v for k, v in got.items() if k.startswith(DECODER_KEYS)} \
        == want


def test_sd14_vae_matches_manifest():
    """Encoder and decoder: every key and shape of diffusers'
    AutoencoderKL."""
    assert _shapes(AutoencoderKL(device="meta")) == _manifest("sd14_vae")


def test_sd14_text_encoder_matches_manifest():
    assert _shapes(CLIPTextModel(device="meta")) == \
        _manifest("sd14_text_encoder")


def _port_sources() -> list[Path]:
    return sorted((ROOT / "polyp_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported(node: ast.AST) -> list[str]:
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module]
    return []


def _module_level_imports(tree: ast.Module) -> list[str]:
    """What importing the module imports: every import statement outside
    a function body (class bodies and `if`/`try` blocks run at import)."""
    names, todo = [], list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        names += _imported(node)
        todo += list(ast.iter_child_nodes(node))
    return names


def test_port_sources_import_no_jax():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        names = [n for node in ast.walk(tree) for n in _imported(node)
                 if n.split(".")[0] in BANNED]
        names += [n for n in _module_level_imports(tree)
                  if n.split(".")[0] in LAZY]
        offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names]
    assert not offenders


# the modules of the distilled slice, which the scans above must reach
SLICE3 = ["polyp_tpu_torch/ops/fused_mha.py", "polyp_tpu_torch/ops/attention.py",
          "polyp_tpu_torch/train/distill.py",
          "polyp_tpu_torch/models/tiny_decoder.py",
          "polyp_tpu_torch/cli/distill_sd.py", "polyp_tpu_torch/pipeline.py",
          "chip_smoke.py"]


# the modules of the LoRA-training slice
SLICE5 = ["polyp_tpu_torch/models/vae.py",
          "polyp_tpu_torch/models/importers.py",
          "polyp_tpu_torch/diffusion/losses.py",
          "polyp_tpu_torch/diffusion/schedule.py",
          "polyp_tpu_torch/data/transforms.py",
          "polyp_tpu_torch/data/pipeline.py",
          "polyp_tpu_torch/configs/base.py",
          "polyp_tpu_torch/utils/checkpoint.py",
          "polyp_tpu_torch/utils/rng.py",
          "polyp_tpu_torch/lora/surgery.py",
          "polyp_tpu_torch/lora/partition.py",
          "polyp_tpu_torch/train/scratch_ddpm.py",
          "polyp_tpu_torch/train/dreambooth.py",
          "polyp_tpu_torch/train/sd_finetune.py",
          "polyp_tpu_torch/train/resume.py",
          "polyp_tpu_torch/cli/common.py",
          "polyp_tpu_torch/cli/sd_common.py"]


# the modules of the augmentation-loop slice
SLICE6 = ["polyp_tpu_torch/configs/base.py",
          "polyp_tpu_torch/data/tables.py",
          "polyp_tpu_torch/data/io.py",
          "polyp_tpu_torch/data/cache.py",
          "polyp_tpu_torch/data/native.py",
          "polyp_tpu_torch/data/transforms.py",
          "polyp_tpu_torch/data/pipeline.py",
          "polyp_tpu_torch/eval/metrics.py",
          "polyp_tpu_torch/eval/quota.py",
          "polyp_tpu_torch/eval/register.py",
          "polyp_tpu_torch/eval/fid.py",
          "polyp_tpu_torch/eval/harness.py",
          "polyp_tpu_torch/track/tracker.py",
          "polyp_tpu_torch/utils/plotting.py",
          "polyp_tpu_torch/models/efficientnet.py",
          "polyp_tpu_torch/models/importers.py",
          "polyp_tpu_torch/train/classifier.py",
          "polyp_tpu_torch/cli/common.py",
          "polyp_tpu_torch/cli/sd_common.py",
          "polyp_tpu_torch/cli/lora_per_class.py",
          "polyp_tpu_torch/cli/train_classifier.py",
          "polyp_tpu_torch/cli/eval_augmentation.py"]


@pytest.mark.parametrize("path", SLICE3 + SLICE5 + SLICE6)
def test_no_jax_scan_covers_the_distilled_slice(path):
    """Each module of the distilled, the LoRA-training and the
    augmentation-loop slices is in the scanned set, is importable as a
    module of the package (or is chip_smoke.py), names no banned package
    anywhere in its source, imports inside functions included, and
    imports matplotlib and mlflow inside functions only."""
    assert ROOT / path in _port_sources()
    tree = ast.parse((ROOT / path).read_text())
    names = [n for node in ast.walk(tree) for n in _imported(node)]
    assert not [n for n in names if n.split(".")[0] in BANNED]
    assert not [n for n in _module_level_imports(tree)
                if n.split(".")[0] in LAZY]
    assert names, "a module that imports nothing was not parsed"


def test_the_lazy_import_scan_sees_module_level_imports():
    """The scan's negative control: a module-level (or `try`-guarded)
    matplotlib import is found, one inside a function is not."""
    tree = ast.parse("import os\ntry:\n    import matplotlib.pyplot\n"
                     "except ImportError:\n    pass\n"
                     "def plot():\n    import mlflow\n")
    assert sorted(_module_level_imports(tree)) == ["matplotlib.pyplot", "os"]


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import polyp_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(polyp_tpu_torch.__path__,\n"
        "                               'polyp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted({{n.split('.')[0] for n in sys.modules}} & "
        f"{BANNED | LAZY!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
