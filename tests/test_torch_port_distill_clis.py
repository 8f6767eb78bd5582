"""The port's distillation CLIs and distilled serving beside polyp_tpu's on
the CPU: polyp-distill, polyp-distill-sd and polyp-distill-vae;
`restore`'s fp32 starting point of an SD student; `load_student_sampler`
and polyp-serve-torch --distilled-dir.

Each CLI pair runs through `main(argv)` on one fabricated corpus in the
reference's layout (tests/test_torch_port_eval_loop.py) with the tiny
models, and must write the same files (the reference writes orbax
directories, the port one file each), the same meta keys and values, and
the same tracker params. As in tests/test_torch_port_cli_rest.py, the
reference's model work is stubbed so that its CLI's own control flow
runs without compiling its models: its parameters come from shapes
(`jax.eval_shape`), its `distill_progressive` returns the teacher's
weights as the student (its phase loop is
tests/test_torch_port_distill.py's), its VAE distiller consumes the
latent batches and returns a shaped decoder, and its samplers return
blank images. The port's CLIs run whole. Values that depend on the two
packages' different generators (losses, rel-L2) are compared by key only.

Tolerances: the fp32 starting point of an SD student 1e-6 of the largest
weight (the same fp32 merge, products summed in another order); a loaded
student's images within 5e-3 of [0, 1] of the reference's given the same
initial latents (generate_batch's bound: one uint8 level); the service's
PNGs equal to the port's sampler's pixel for pixel.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from polyp_tpu.cli import distill as jdistill_cli
from polyp_tpu.cli import distill_sd as jdsd
from polyp_tpu.cli import distill_vae as jdvae_cli
from polyp_tpu.cli import sd_common as jsd
from polyp_tpu.configs import DiffusionConfig as JDiffusionConfig
from polyp_tpu.lora import LoRAConfig as JLoRAConfig
from polyp_tpu.lora import init_lora as jinit_lora
from polyp_tpu.lora import save_lora as jsave_lora
from polyp_tpu.models import unet2d as junet2d
from polyp_tpu.train import distill_vae as jdvae
from polyp_tpu.train.distill import DistillPhaseResult as JPhase
from polyp_tpu.train.distill import DistillResult as JResult
from polyp_tpu.utils.checkpoint import save_pytree as jsave_pytree
from polyp_tpu_torch import serve as tserve
from polyp_tpu_torch.cli import common as tcommon
from polyp_tpu_torch.cli import distill, distill_sd, distill_vae, sd_common
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.lora import save_lora
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models.tiny_decoder import load_tiny_decoder
from polyp_tpu_torch.ops import quant as tquant
from polyp_tpu_torch.pipeline import to_uint8
from polyp_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from test_torch_port_cli_rest import _common, _listing, _run_params
from test_torch_port_eval_loop import _jax_sd_stack, fabricate_corpus
from test_torch_port_lora import (
    _init_like, jax_tiny_stack, port_tiny_stack, write_diffusers_dir)
from test_torch_port_train import _nudged

LIMIT_S = 600   # each test's own limit: 3.5x its longest on a busy worker


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own time limit: SIGALRM raises past LIMIT_S."""
    def expired(signum, frame):
        raise TimeoutError(f"the test ran past its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _shaped(tree):
    """Zeros of a shape tree (jax.eval_shape's output)."""
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  tree)


class _ShapedInit:
    """A flax module whose `init` returns zeros of its parameter shapes
    (no eager init); everything else is the module's."""

    def __init__(self, module):
        self.module = module

    def init(self, *args, **kwargs):
        return _shaped(jax.eval_shape(self.module.init, *args, **kwargs))

    def __getattr__(self, name):
        return getattr(self.module, name)


def _student_result(teacher_params, schedule, batches, start_steps,
                    end_steps, steps_per_phase, student_prediction_type,
                    **kwargs):
    """The reference's distill_progressive, stubbed: the teacher's weights
    as the student, one zero loss a phase."""
    phases, n = [], start_steps
    while n > end_steps:
        n //= 2
        phases.append(JPhase(num_steps=n, losses=[0.0]))
    return JResult(params=teacher_params, num_steps=end_steps,
                   prediction_type=student_prediction_type, phases=phases)


def _blank(size: int):
    return lambda batch_size, key: jnp.zeros((batch_size, size, size, 3))


def _models_listing(run: Path) -> list[str]:
    return sorted(p.name for p in (run / "models").iterdir())


def _same_params(tmp: Path, model_dirs: dict) -> None:
    """Both runs' tracker params equal, each naming its own model dir."""
    params = {k: _run_params(tmp / f"mlruns_{k}") for k in model_dirs}
    for k, d in model_dirs.items():
        assert params[k].pop("teacher_model_dir") == str(d)
    assert params["torch"] == params["jax"]


def _meta(run: Path, name: str) -> dict:
    return json.loads((run / "models" / name).read_text())


FLAGS = ["--tiny", "--one_vs_rest", "--start_steps", "4", "--end_steps", "2",
         "--steps_per_phase", "1", "--generate", "2"]


def test_distill_cli_matches_the_reference(tmp_path, monkeypatch):
    """polyp-distill --tiny beside the reference's on one corpus (AD and
    REST, 16 px, 4 → 2 at one step a phase, 2 samples a class), each over
    its own package's checkpoints of the same teacher: the same files,
    meta and tracker params; the port's students finite."""
    layout = fabricate_corpus(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    jm = junet2d.tiny_scratch_unet()
    params = _init_like(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
        jnp.zeros((1,), jnp.int32))["params"], seed=2)
    teachers = {"jax": tmp_path / "teach_jax", "torch": tmp_path / "teach_t"}
    for cls in ("AD", "REST"):
        jsave_pytree(teachers["jax"] / "models" / f"model_{cls}",
                     {"params": params})
        save_pytree(teachers["torch"] / "models" / f"model_{cls}",
                    {"params": timp.unet2d_from_jax(params)})
    monkeypatch.setattr(jdistill_cli, "tiny_scratch_unet",
                        lambda: _ShapedInit(junet2d.tiny_scratch_unet()))
    monkeypatch.setattr(jdistill_cli, "distill_progressive",
                        lambda apply_fn, *args, **kwargs:
                        _student_result(*args, **kwargs))
    monkeypatch.setattr(jdistill_cli, "PixelDiffusionSampler",
                        lambda model, params, schedule, size, *args,
                        **kwargs: _blank(size))
    runs = {}
    for name, main in (("jax", jdistill_cli.main), ("torch", distill.main)):
        out = tmp_path / name
        argv = _common(tmp_path, layout.root, name) + FLAGS + [
            "--image_size", "16", "--model-dir", str(teachers[name]),
            "--output-dir", str(out)]
        main(argv + (["--device", "cpu"] if name == "torch" else []))
        runs[name] = out
    assert _listing(runs["torch"]) == _listing(runs["jax"])
    assert "samples/REST/2.png" in _listing(runs["jax"])
    assert _models_listing(runs["torch"]) == _models_listing(runs["jax"]) \
        == ["distilled_AD", "distilled_AD_meta.json", "distilled_REST",
            "distilled_REST_meta.json"]
    for cls in ("AD", "REST"):
        name = f"distilled_{cls}_meta.json"
        assert _meta(runs["torch"], name) == _meta(runs["jax"], name)
        tree = load_pytree(runs["torch"] / "models" / f"distilled_{cls}")
        assert set(tree["params"]) == set(timp.unet2d_from_jax(params))
        assert all(torch.isfinite(v).all() for v in tree["params"].values())
    _same_params(tmp_path, teachers)


def _lora_bundles(jax_dir: Path, torch_dir: Path, classes) -> None:
    """One nudged UNet adapter a class (the config's rank and modules) in
    each package's format, the same values."""
    unet_params = jax_tiny_stack()[1]
    cfg = DiffusionConfig()
    lcfg = JLoRAConfig(cfg.lora_rank, cfg.lora_alpha, cfg.lora_dropout,
                       cfg.modules_lora)
    for i, cls in enumerate(classes):
        adapter = _nudged(jinit_lora(unet_params, lcfg,
                                     jax.random.PRNGKey(i)), 30 + i)
        jsave_lora(jax_dir / f"lora_{cls}", {"unet_lora": adapter})
        save_lora(torch_dir / f"lora_{cls}",
                  {"unet_lora": timp.lora_from_jax(adapter)})


def test_distill_sd_cli_matches_the_reference(tmp_path, monkeypatch):
    """polyp-distill-sd --tiny beside the reference's over the same LoRA
    bundles (AD and REST, 32 px, batch 2, 4 → 2 at one step a phase, 2
    samples a class): the same files, meta (the prompt, the folded
    guidance, the trailing grid), cond embeddings of the same shape, and
    tracker params; the port's students finite."""
    layout = fabricate_corpus(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    bundles = {"jax": tmp_path / "lora_jax", "torch": tmp_path / "lora_t"}
    _lora_bundles(bundles["jax"], bundles["torch"], ("AD", "REST"))
    monkeypatch.setattr(jdsd, "load_sd_stack",
                        lambda *args, **kwargs: _jax_sd_stack())
    monkeypatch.setattr(jdsd, "distill_progressive",
                        lambda apply_fn, *args, **kwargs:
                        _student_result(*args, **kwargs))

    class BlankStudent:
        def __init__(self, stack, result, text_params, config, **kwargs):
            self.size = config.image_size

        def for_prompt(self, prompt):
            return _blank(self.size)

    monkeypatch.setattr(jdsd, "make_student_sampler", BlankStudent)
    runs = {}
    for name, main in (("jax", jdsd.main), ("torch", distill_sd.main)):
        out = tmp_path / name
        argv = _common(tmp_path, layout.root, name) + FLAGS + [
            "--image_size", "32", "--train_batch_size", "2",
            "--model-dir", str(bundles[name]), "--output-dir", str(out)]
        main(argv + (["--device", "cpu"] if name == "torch" else []))
        runs[name] = out
    assert _listing(runs["torch"]) == _listing(runs["jax"])
    assert "samples/AD/2.png" in _listing(runs["jax"])
    assert _models_listing(runs["torch"]) == _models_listing(runs["jax"])
    for cls in ("AD", "REST"):
        name = f"distilled_{cls}_meta.json"
        got, want = _meta(runs["torch"], name), _meta(runs["jax"], name)
        assert got == want and got["guidance"] == "folded"
        cond = [np.load(r / "models" / f"distilled_{cls}_cond.npy")
                for r in (runs["torch"], runs["jax"])]
        assert cond[0].dtype == cond[1].dtype == np.float32
        assert cond[0].shape == cond[1].shape
        tree = load_pytree(runs["torch"] / "models" / f"distilled_{cls}")
        assert all(torch.isfinite(v).all() for v in tree["params"].values())
    _same_params(tmp_path, bundles)


def test_sd_student_starts_from_the_fp32_merge(tmp_path):
    """A bf16 stack carrying the reference's tiny weights: the student's
    fp32 masters (sd_common.fp32_unet_params) are the reference's merged
    params (restore_class_params: fp32 base + fp32 LoRA delta), not the
    bf16 weights merged_stack samples with."""
    bundles = {"jax": tmp_path / "lora_jax", "torch": tmp_path / "lora_t"}
    _lora_bundles(bundles["jax"], bundles["torch"], ("AD",))
    jcfg, cfg = JDiffusionConfig(), DiffusionConfig()
    merged, _ = jsd.restore_class_params(_jax_sd_stack(), jcfg,
                                         bundles["jax"], "AD")
    want = timp.unet_from_jax(jax.tree_util.tree_map(np.asarray, merged))
    stack = tcommon.load_sd_stack(write_diffusers_dir(tmp_path / "sd",
                                                      "safetensors"),
                                  dtype=torch.bfloat16, tiny=True,
                                  device="cpu")
    bundle = sd_common.load_class_bundle(stack, bundles["torch"], "AD")
    got = sd_common.fp32_unet_params(stack, cfg, bundle)
    assert set(got) == set(want)
    top = max(w.abs().max().item() for w in want.values())
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        assert (got[k] - w).abs().max().item() <= 1e-6 * top, k
    rounded = sd_common.attach_bundle(stack, cfg, "AD", bundle).unet
    merged_keys = [f"{m}.weight" for m in bundle["unet_lora"]]
    assert any(not torch.equal(got[k], rounded.get_parameter(k).float())
               for k in merged_keys)


def test_distill_vae_cli_matches_the_reference(tmp_path, monkeypatch):
    """polyp-distill-vae --tiny beside the reference's with a corpus
    (mixed latents; 32 px, batch 2, 2 steps, 8 channels): the same files
    by role (params + meta.json), meta keys and deterministic values,
    tracker params; the port's decoder loads with load_tiny_decoder and
    decodes finite images."""
    layout = fabricate_corpus(tmp_path / "data")
    monkeypatch.setattr(jdvae_cli, "load_sd_stack",
                        lambda *args, **kwargs: _jax_sd_stack())

    def consumed(vae, vae_vars, decoder, batches, learning_rate=3e-4,
                 holdout=None, **kwargs):
        n = sum(1 for z in batches if z.shape[-1] == vae.latent_channels)
        params = _shaped(jax.eval_shape(
            decoder.init, jax.random.PRNGKey(0),
            jnp.zeros((1,) + holdout.shape[1:], jnp.float32)))["params"]
        meta = {"base_channels": decoder.base_channels,
                "latent_channels": decoder.latent_channels,
                "blocks_per_stage": decoder.blocks_per_stage, "steps": n,
                "learning_rate": learning_rate, "final_loss": 0.0,
                "rel_l2": 0.0}
        return jdvae.VAEDistillResult(params=params, losses=[0.0] * n,
                                      rel_l2=0.0, meta=meta)

    monkeypatch.setattr(jdvae_cli, "distill_vae_decoder", consumed)
    runs = {}
    for name, main in (("jax", jdvae_cli.main), ("torch", distill_vae.main)):
        out = tmp_path / name
        argv = _common(tmp_path, layout.root, name) + [
            "--tiny", "--image_size", "32", "--batch", "2", "--steps", "2",
            "--base_channels", "8", "--output-dir", str(out)]
        main(argv + (["--device", "cpu"] if name == "torch" else []))
        runs[name] = out
    assert sorted(p.name for p in runs["jax"].iterdir()) == [
        "meta.json", "params"]
    assert sorted(p.name for p in runs["torch"].iterdir()) == [
        "meta.json", "params.npz"]
    got, want = (json.loads((runs[k] / "meta.json").read_text())
                 for k in ("torch", "jax"))
    assert set(got) == set(want)
    for k in ("base_channels", "latent_channels", "blocks_per_stage",
              "steps", "learning_rate", "image_size", "latent_source"):
        assert got[k] == want[k], k
    assert got["latent_source"] == "mixed" and got["steps"] == 2
    assert _run_params(tmp_path / "mlruns_torch") == \
        _run_params(tmp_path / "mlruns_jax")
    decoder, meta = load_tiny_decoder(runs["torch"], dtype=torch.float32,
                                      device="cpu")
    assert meta == got
    with torch.no_grad():
        images = decoder(torch.randn(2, 4, 4, 4))
    assert images.shape == (2, 3, 32, 32) and torch.isfinite(images).all()


def _students(root: Path, fmt: str, classes) -> dict:
    """A polyp-distill-sd output in `fmt` ("jax" or "torch"): per class
    nudged tiny-UNet weights, a seeded cond embedding and the meta (2
    steps, a v-prediction head, 32 px). Returns {cls: prompt}."""
    up = jax_tiny_stack()[1]
    prompts = {}
    models = root / "models"
    for i, cls in enumerate(classes):
        params = _nudged(up, 40 + i)
        if fmt == "jax":
            jsave_pytree(models / f"distilled_{cls}", {"params": params})
        else:
            save_pytree(models / f"distilled_{cls}",
                        {"params": timp.unet_from_jax(params)})
        cond = np.random.default_rng(50 + i).standard_normal(
            (1, 16, 32)).astype(np.float32)
        np.save(models / f"distilled_{cls}_cond.npy", cond)
        prompts[cls] = f"a special {cls} polyp"
        (models / f"distilled_{cls}_meta.json").write_text(json.dumps({
            "num_steps": 2, "prediction_type": "v_prediction",
            "sampler": "ddim", "sampler_kwargs": {"spacing": "trailing",
                                                  "steps_offset": 0},
            "guidance": "folded", "guidance_scale": 7.5,
            "prompt": prompts[cls], "image_size": 32,
            "num_train_timesteps": 1000}))
    return prompts


def _png_pixels(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_student_sampler_and_distilled_serving_match(tmp_path, monkeypatch):
    """load_student_sampler on each package's copy of one student (its
    saved cond embedding registered for its prompt): images within 5e-3
    of the reference's from the same initial latents. Then
    polyp-serve-torch's service over --distilled-dir with two students
    (`--distilled-class all`): both models hosted and warm, each request
    answered by its own student, pixel-equal to load_student_sampler's
    generate_batch; `--quantize promoted` resolved to the port's
    distilled verdict, and refused by polyp-serve-torch where that entry
    is demoted."""
    prompts = _students(tmp_path / "jax", "jax", ("AD",))
    _students(tmp_path / "torch", "torch", ("AD", "HP"))
    want = jdsd.load_student_sampler(
        _jax_sd_stack(), tmp_path / "jax", "AD",
        JDiffusionConfig(image_size=32)).for_prompt(prompts["AD"])(
            2, jax.random.PRNGKey(3))
    stack = port_tiny_stack()
    sampler = distill_sd.load_student_sampler(stack, tmp_path / "torch",
                                              "AD", image_size=32)
    # the reference's DDIM draws its initial latents from split(key)[1]
    init = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(3))[1], (2, 4, 4, 4)))
    with torch.no_grad():
        got = sampler.generate(sampler.encode_prompt(prompts["AD"]), None, 2,
                               init=torch.from_numpy(
                                   init.transpose(0, 3, 1, 2).copy()))
    want01 = (np.asarray(want, np.float64) + 1) / 2
    got01 = (got.numpy().transpose(0, 2, 3, 1).astype(np.float64) + 1) / 2
    assert np.abs(np.clip(got01, 0, 1) - np.clip(want01, 0, 1)).max() \
        <= 5e-3
    gate = tmp_path / "quant_gate.json"
    monkeypatch.setattr(tquant, "GATE_PATH", gate)
    gate.write_text(json.dumps({"promoted_distilled": {
        "mode": "w8a8_static", "quant_fp_head": 0, "quant_fp_tail": 0,
        "gate_pass": True}}))
    promoted = distill_sd.load_student_sampler(
        stack, tmp_path / "torch", "AD", quantize="promoted")
    assert (promoted.quantize, promoted._split) == ("w8a8_static", None)
    gate.write_text(json.dumps({"promoted_distilled": {
        "mode": "w8a8_static", "quant_fp_head": 0, "quant_fp_tail": 0,
        "gate_pass": False}}))

    monkeypatch.setattr(tcommon, "load_sd_stack",
                        lambda *args, **kwargs: stack)
    args = argparse.Namespace(
        distilled_dir=str(tmp_path / "torch"), distilled_class="all",
        pretrained_dir=None, tiny=True, device="cpu", image_size=32,
        steps=25, quantize=None, quant_fp_head=0, quant_fp_tail=0,
        vae_decoder="full", tiny_decoder_dir=None, max_batch=2,
        batch_window_ms=1.0, pipeline_depth=1, max_pending=8,
        request_timeout_s=None)
    service = tserve.service_from_args(args)
    try:
        assert service.models == ["AD", "HP"] and service.warm
        assert service.model_name == "polyp-sd-distilled[AD,HP]"
        for cls in ("AD", "HP"):
            prompt = f"a special {cls} polyp"
            reply = service.generate(prompt, 1, seed=5, model=cls)
            assert reply["model"] == cls
            own = distill_sd.load_student_sampler(
                stack, tmp_path / "torch", cls, image_size=32)
            expect = to_uint8(own.generate_batch([prompt], [(5, 0)],
                                                 pad_to=2))[0]
            np.testing.assert_array_equal(_png_pixels(reply["images"][0]),
                                          expect)
    finally:
        service.close()
    with pytest.raises(SystemExit, match="quant_gate.json"):
        tserve.main(["--distilled-dir", str(tmp_path / "torch"),
                     "--quantize", "promoted"])


def test_distill_clis_default_to_the_card(tmp_path):
    """Without --device, the three CLIs build on CUDA and raise where
    there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    layout = fabricate_corpus(tmp_path / "data")
    common = _common(tmp_path, layout.root, "card") + ["--tiny"]
    for main, extra in (
            (distill.main, ["--model-dir", str(tmp_path / "m")]),
            (distill_sd.main, ["--model-dir", str(tmp_path / "m")]),
            (distill_vae.main, ["--output-dir", str(tmp_path / "v")])):
        with pytest.raises(RuntimeError, match="no card|CUDA"):
            main(common + extra)
