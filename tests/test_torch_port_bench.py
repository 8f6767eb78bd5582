"""polyp-bench-torch (polyp_tpu_torch/cli/bench.py) against the repo-root
bench.py and the JAX package on the CPU, and the port's Adafactor against
optax.

* Both mains side by side: the same fake bench functions under the same
  gate verdict (none, full-trajectory passing, distilled passing) must be
  called with the same arguments and print the same JSON line, key for
  key, apart from the port's `card`; the flag refusals, the promoted
  resolution and the watchdog's contract as tests/test_bench_cli.py and
  tests/test_bench_watchdog.py pin them for the reference; a failed
  companion keeps the headline and exits 1.
* The timed callables at the --quick size (fp32 tiny models, the
  reference's weights through models.importers, numpy initial latents
  handed to both as `init`) against the JAX package's composition of the
  same functions as bench.py composes them (sample, with_cfg, vae.decode),
  at the whole-slice tolerance 5e-3; the int8 modes by the calls they
  make (never one whole int8 forward against another).
* The int8 VAE decode: exactly full precision on tiny_vae (every conv
  below the channel gate), and on a decoder with 64/128-wide levels held
  to the JAX package's decode with the codes forced (ForcedCodes), every
  quantize call checked.
* Adafactor (train/adafactor.py) against optax.chain(
  clip_by_global_norm(1.0), adafactor(1e-4)) over three steps.
* The training benches at a tiny size, and the distill bench's OOM ladder.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyp_tpu.diffusion import samplers as jsamp
from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu.models.vae import AutoencoderKL as JVAE
from polyp_tpu.ops import quant as jq
from polyp_tpu.pipeline import _precision_split as j_precision_split
from polyp_tpu_torch.cli import bench as tbench
from polyp_tpu_torch.cli.common import load_sd_stack
from polyp_tpu_torch.configs import ClassificationConfig
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models.unet_condition import tiny_condition_unet
from polyp_tpu_torch.models.vae import AutoencoderKL as TVAE
from polyp_tpu_torch.ops import quant as tq
from polyp_tpu_torch.pipeline import _precision_split
from polyp_tpu_torch.train.adafactor import Adafactor, factored_dims
from test_torch_port_lora import _init_like, jax_tiny_stack, port_tiny_stack
from test_torch_port_quant import ForcedCodes, _rel

ROOT = Path(__file__).resolve().parents[1]
SD_SCHEDULE = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                   beta_start=0.00085, beta_end=0.012)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file. The tiny models' many small CPU
    ops each open an OpenMP region; when the suite's parallel workers each
    run a thread per core, every region waits for cores (these tests took
    about 80 times longer in the 6-worker run than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def ref_bench():
    """The repo-root bench.py (the reference's polyp-bench). Importing it
    points JAX's persistent compilation cache at /tmp; the process's
    setting is put back."""
    saved = {name: getattr(jax.config, name) for name in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    sys.path.insert(0, str(ROOT))
    try:
        import bench
    finally:
        sys.path.remove(str(ROOT))
        for name, value in saved.items():
            jax.config.update(name, value)
    return bench


# ---------------------------------------------------------------------------
# Both mains with the same fakes
# ---------------------------------------------------------------------------

PROMO = {"mode": "w8a8_static", "quant_fp_head": 3, "quant_fp_tail": 0,
         "batch": 16, "rel_l2_25step": 0.0388, "gate_pass": True}
DPROMO = {"mode": "w8a8_static", "quant_fp_head": 0, "quant_fp_tail": 0,
          "gate_pass": True}
VERDICTS = {"none": (None, None), "full": (PROMO, None),
            "distilled": (None, DPROMO)}


class Fakes:
    """Bench functions that record their calls (the port's `device`
    argument dropped) and return fixed, call-dependent numbers."""

    def __init__(self):
        self.calls = []

    def _record(self, name, args, kw):
        kw = {k: v for k, v in kw.items() if k != "device"}
        self.calls.append((name, args, kw))
        return 1.0 + 0.25 * len(self.calls)

    def sampling(self, batch, image_size, steps, sampler, quick, **kw):
        rate = self._record("sampling", (batch, image_size, steps, sampler,
                                         quick), kw)
        return {"samples_per_sec": rate, "batch_size": batch}

    def distilled(self, batch, image_size, steps, quick=False, **kw):
        rate = self._record("distilled", (batch, image_size, steps, quick),
                            kw)
        out = {"samples_per_sec": rate, "steps": steps, "batch_size": batch,
               "unet_scan_sec": 0.1 * rate, "vae_decode_sec": 0.05,
               "vae_share": 0.33}
        if kw.get("quantize"):
            out["quant_rel_l2"] = 0.012
        if kw.get("quantize_vae"):
            out["vae_q_rel_l2"] = 0.07
        if kw.get("tiny_decoder"):
            out["tiny_rel_l2"] = 0.356
        return out

    def classifier(self, *args, **kw):
        return {"train_images_per_sec": self._record("classifier", args,
                                                     kw)}

    def lora(self, *args, **kw):
        return {"sd_lora_train_images_per_sec": self._record("lora", args,
                                                             kw),
                "compile_sec": 1.0}

    def install(self, monkeypatch, module):
        for name, fn in (("bench_sampling", self.sampling),
                         ("bench_distilled", self.distilled),
                         ("bench_classifier_train", self.classifier),
                         ("bench_sd_lora_train", self.lora)):
            monkeypatch.setattr(module, name, fn)


def _verdict(monkeypatch, ref, promo, dpromo):
    """Both packages' gate lookups return `promo` / `dpromo`."""
    def promoted(distilled=False):
        return dpromo if distilled else promo

    monkeypatch.setattr(jq, "promoted_config", promoted)
    monkeypatch.setattr(tq, "promoted_config", promoted)
    if ref is not None:
        monkeypatch.setattr(ref, "_promoted_quant", lambda: promo)


def _last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_ref(ref, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["bench.py", "--watchdog", "0", *argv])
    ref.main()


def _run_port(argv) -> int:
    return tbench.main(["--watchdog", "0", "--device", "cpu", *argv])


@pytest.mark.parametrize("verdict,argv", [
    ("none", []), ("full", []), ("distilled", []),
    ("none", ["--train", "--train-diffusion"]),
    ("full", ["--train", "--train-diffusion"]),
    ("full", ["--batch", "4"]),
    ("none", ["--quick", "--steps", "3"]),
    ("none", ["--quantize", "w8a8", "--quant-fp-head", "2"]),
    ("full", ["--quick", "--quantize", "promoted"]),
    ("distilled", ["--distilled", "8", "--quantize", "promoted"]),
    ("none", ["--distilled", "4", "--batch", "32", "--quantize-vae"]),
    ("none", ["--distilled", "8", "--tiny-decoder"]),
])
def test_mains_side_by_side(ref_bench, monkeypatch, capsys, tmp_path,
                            verdict, argv):
    """The same calls with the same arguments and the same line, key for
    key, apart from `card` (cwd without ./models/tiny_decoder, so the
    reference passes the tiny decoder dir None as the port always does:
    the port's None is its shipped weights)."""
    monkeypatch.chdir(tmp_path)
    _verdict(monkeypatch, ref_bench, *VERDICTS[verdict])
    ref_fakes, port_fakes = Fakes(), Fakes()
    ref_fakes.install(monkeypatch, ref_bench)
    _run_ref(ref_bench, monkeypatch, argv)
    want = _last_line(capsys)
    port_fakes.install(monkeypatch, tbench)
    assert _run_port(argv) == 0
    got = _last_line(capsys)
    assert port_fakes.calls == ref_fakes.calls
    assert got.pop("card") == "cpu"
    assert got == want


def test_companion_failure_keeps_headline_and_exits_1(monkeypatch, capsys):
    """The reference writes `*_error` and exits 0; the port writes the
    same field, keeps the measured headline, and exits 1."""
    _verdict(monkeypatch, None, None, None)
    fakes = Fakes()
    fakes.install(monkeypatch, tbench)

    def sampling(batch, *args, quantize=None, **kw):
        if quantize == "w8a8_static":
            raise RuntimeError("companion broke")
        return fakes.sampling(batch, *args, quantize=quantize, **kw)

    monkeypatch.setattr(tbench, "bench_sampling", sampling)
    assert _run_port([]) == 1
    line = _last_line(capsys)
    assert line["value"] > 0
    assert line["w8a8_static_error"] == "RuntimeError: companion broke"
    assert "distilled_value" in line


def test_malformed_gate_file_raises(monkeypatch, tmp_path):
    """A gate file that does not parse is an error, not a demotion (the
    reference's _promoted_quant swallows it)."""
    bad = tmp_path / "quant_gate.json"
    bad.write_text("{not json")
    monkeypatch.setattr(tq, "GATE_PATH", bad)
    Fakes().install(monkeypatch, tbench)
    with pytest.raises(ValueError, match="does not parse"):
        _run_port([])


@pytest.mark.parametrize("argv,match", [
    (["--distilled", "8", "--quantize", "w8a8_static", "--quant-fp-head",
      "2"], "hybrid-precision"),
    (["--distilled", "4", "--quantize", "w8a8_static", "--quant-fp-tail",
      "1"], "hybrid-precision"),
    (["--distilled", "8", "--train"], "standalone"),
    (["--distilled", "8", "--tiny-decoder", "--quantize-vae"],
     "alternative decode levers"),
])
def test_refusals_match_the_reference(ref_bench, monkeypatch, argv, match):
    for run in (lambda: _run_ref(ref_bench, monkeypatch, argv),
                lambda: _run_port(argv)):
        with pytest.raises(SystemExit, match=match):
            run()


def test_promoted_refused_when_demoted(monkeypatch):
    """--quantize promoted under a demoted verdict exits naming the gate
    file, as every other surface of the port does."""
    _verdict(monkeypatch, None, None, None)
    with pytest.raises(SystemExit, match="quant_gate.json"):
        _run_port(["--quantize", "promoted"])


def test_bench_distilled_refuses_both_decode_levers():
    """The function itself refuses (the reference's lets the tiny decoder
    silently win), before any model is built."""
    with pytest.raises(ValueError, match="alternative decode levers"):
        tbench.bench_distilled(2, 64, 2, quick=True, quantize_vae=True,
                               tiny_decoder=True, device="cpu")


def test_reference_baseline_copied(ref_bench, tmp_path):
    assert tbench.BASELINE_PATH.read_bytes() == (
        ROOT / "tools" / "reference_baseline.json").read_bytes()
    assert (tbench.REFERENCE_CPU_SAMPLES_PER_SEC,
            tbench.REFERENCE_CPU_THREADS) == (
        ref_bench.REFERENCE_CPU_SAMPLES_PER_SEC,
        ref_bench.REFERENCE_CPU_THREADS)
    assert tbench.REFERENCE_NORMALIZED_CORES == \
        ref_bench.REFERENCE_NORMALIZED_CORES
    with pytest.raises(FileNotFoundError):
        tbench._reference_baseline(tmp_path / "absent.json")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"torch_cpu_samples_per_sec": 0.0,
                               "threads": 1}))
    with pytest.raises(ValueError):
        tbench._reference_baseline(bad)


def test_watchdog_lines_and_disarm(monkeypatch, capsys):
    """The contract of tests/test_bench_watchdog.py, in process with
    os._exit recorded: a measured partial result is printed with
    `watchdog_error`, nothing measured gives the error line naming the
    card, each then exits 2; a disarmed watchdog prints nothing and does
    not exit."""
    import threading

    codes, fired = [], threading.Event()

    def exit_(code):
        codes.append(code)
        fired.set()

    monkeypatch.setattr(tbench.os, "_exit", exit_)
    _, partial = tbench._arm_watchdog(0.2, "cpu")
    partial["out"] = {"metric": "m", "value": 1.5}
    assert fired.wait(10)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 1.5 and "watchdog_error" in line
    fired.clear()
    tbench._arm_watchdog(0.2, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert fired.wait(10)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert codes == [2, 2]
    assert line["unit"] == "error" and "unresponsive" in line["error"]
    assert "NVIDIA H100" in line["error"]
    fired.clear()
    done, _ = tbench._arm_watchdog(0.2, "cpu")
    done.set()
    assert not fired.wait(0.5)
    assert codes == [2, 2] and capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# The timed callables against the JAX package's composition
# ---------------------------------------------------------------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _embeddings(seed=11, ctx_dim=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 77, ctx_dim)).astype(np.float32),
            np.zeros((1, 77, ctx_dim), np.float32))


def _init(seed, batch, latent=4):
    return np.random.default_rng(seed).standard_normal(
        (batch, latent, latent, 4)).astype(np.float32)


def test_sampling_fn_matches_jax_composition():
    """bench.py:324-342 in JAX (with_cfg 7.5 → sample → vae.decode of the
    latents cast to the VAE's dtype over 0.18215) and the port's
    make_sampling_fn, fp32, 2 DDIM steps, 32 px, the same init: 5e-3."""
    unet, up, vae, vp, _, _ = jax_tiny_stack()
    stack = port_tiny_stack()
    cond, uncond = _embeddings()
    init = _init(5, 2)

    @jax.jit  # as bench.py:324 jits its generate
    def j_generate(up, vp, cond, uncond, init):
        def raw(z, tt, emb):
            return unet.apply({"params": up}, z, tt, emb)

        model_fn = jsamp.with_cfg(raw, cond, uncond, 7.5)
        latents = jsamp.sample("ddim", model_fn,
                               jsched.DiffusionSchedule.create(**SD_SCHEDULE),
                               init.shape, jax.random.PRNGKey(0), 2,
                               init=init)
        return vae.apply({"params": vp},
                         latents.astype(jnp.float32) / 0.18215,
                         method=vae.decode)

    want = j_generate(up, vp, jnp.asarray(cond), jnp.asarray(uncond),
                      jnp.asarray(init))
    generate = tbench.make_sampling_fn(
        stack.unet, stack.vae, tsched.DiffusionSchedule.create(**SD_SCHEDULE),
        torch.from_numpy(cond), torch.from_numpy(uncond), 2, 32, 2, "ddim")
    got = generate(None, init=_nchw(init))
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=5e-3,
                               atol=5e-3)


def test_distilled_fns_match_jax_composition():
    """bench.py:432-483: cond-only trailing DDIM (2 steps, batch 4) and the
    decode of its latents, fp32, 32 px, the same init: 5e-3."""
    unet, up, vae, vp, _, _ = jax_tiny_stack()
    stack = port_tiny_stack()
    cond, _ = _embeddings(12)
    init = _init(6, 4)
    @jax.jit  # as bench.py:482 jits its denoise
    def j_denoise(up, cond, init):
        model_fn = jsamp.with_cfg(
            lambda z, tt, emb: unet.apply({"params": up}, z, tt, emb),
            cond, None, None)
        return jsamp.sample("ddim", model_fn,
                            jsched.DiffusionSchedule.create(**SD_SCHEDULE),
                            init.shape, jax.random.PRNGKey(0), 2,
                            spacing="trailing", steps_offset=0, init=init)

    latents = j_denoise(up, jnp.asarray(cond), jnp.asarray(init))
    denoise = tbench.make_denoiser(
        stack.unet, tsched.DiffusionSchedule.create(**SD_SCHEDULE),
        torch.from_numpy(cond), 4, 32, 2)
    got_latents = denoise(None, init=_nchw(init))
    np.testing.assert_allclose(_nhwc(got_latents), np.asarray(latents),
                               rtol=2e-3, atol=2e-3)
    want = jax.jit(lambda vp, z: vae.apply({"params": vp}, z / 0.18215,
                                           method=vae.decode))(vp, latents)
    got = tbench.make_decoder(stack.vae)(got_latents, None)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=5e-3,
                               atol=5e-3)


class _ModeRecorder(torch.nn.Module):
    """The UNet, recording the quantization mode each call runs under."""

    def __init__(self, unet):
        super().__init__()
        self.unet, self.modes = unet, []

    def forward(self, z, t, emb):
        self.modes.append(tq.quantization())
        return self.unet(z, t, emb)


@pytest.mark.parametrize("quantize,head,tail", [
    ("w8a8_static", 1, 0), ("w8a8_static", 0, 1), ("w8a8", 0, 0),
    ("w8a8_static", 2, 1)])
def test_int8_sampling_makes_the_reference_calls(quantize, head, tail):
    """The split is the reference's (_precision_split on both sides) and
    each UNet call runs under the segment's mode: the fp head and tail in
    full precision, the middle quantized, w8a8_static with its scales."""
    steps = 3
    assert _precision_split(steps, quantize, head, tail) == \
        j_precision_split(steps, quantize, head, tail)
    mode, split = _precision_split(steps, quantize, head, tail)
    stack = port_tiny_stack()
    unet = _ModeRecorder(stack.unet)
    cond, uncond = _embeddings()
    scales = ({"down_blocks.1.resnets.0.conv1": 0.05}
              if quantize == "w8a8_static" else None)
    generate = tbench.make_sampling_fn(
        unet, stack.vae, tsched.DiffusionSchedule.create(**SD_SCHEDULE),
        torch.from_numpy(cond), torch.from_numpy(uncond), 2, 32, steps,
        "ddim", mode, split, scales)
    out = generate(None, init=_nchw(_init(7, 2)))
    assert torch.isfinite(out).all()
    head, tail = split if split else (0, 0)
    want = [None] * head + [mode] * (steps - head - tail) + [None] * tail
    assert unet.modes == want


def test_folded_int8_denoise_makes_the_reference_calls():
    stack = port_tiny_stack()
    unet = _ModeRecorder(stack.unet)
    denoise = tbench.make_denoiser(
        unet, tsched.DiffusionSchedule.create(**SD_SCHEDULE),
        torch.from_numpy(_embeddings()[0]), 2, 32, 4, "w8a8")
    assert torch.isfinite(denoise(None, init=_nchw(_init(8, 2)))).all()
    assert unet.modes == ["w8a8"] * 4


# ---------------------------------------------------------------------------
# The int8 VAE decode
# ---------------------------------------------------------------------------

def test_vae_q_rel_l2_is_zero_on_tiny_vae():
    """tiny_vae's convs all sit below quant.MIN_QUANT_CHANNELS (64), so
    the int8 decode is full precision there, bit for bit, as the
    reference's bench test pins; the bench line's fields are there."""
    d = tbench.bench_distilled(2, 64, 2, quick=True, repeats=1,
                               quantize_vae=True, device="cpu")
    assert d["vae_q_rel_l2"] == 0.0
    assert d["steps"] == 2 and d["batch_size"] == 2
    assert d["unet_scan_sec"] > 0 and d["vae_decode_sec"] > 0
    assert 0.0 < d["vae_share"] < 1.0 and "quant_rel_l2" not in d


WIDE_VAE = (64, 128)


def test_int8_vae_decode_matches_jax_with_codes_forced():
    """A decoder with 64/128-wide levels (two of them, the JAX side eager
    so its quantize calls can be recorded) under w8a8 (every ResnetBlock2D
    conv, 1×1 shortcut, upsample conv and mid-attention projection
    quantizes, as in the reference): each of the port's activation
    quantize calls against JAX's in order (the same scale, codes at most
    one apart in a small share), continued with JAX's codes; the decodes
    then agree to relative L2 1e-5."""
    vae = JVAE(block_out_channels=WIDE_VAE, dtype=jnp.float32)
    k = jax.random.PRNGKey(0)
    vp = _init_like(jax.eval_shape(vae.init, k, jnp.zeros((1, 8, 8, 3)),
                                   k)["params"], 9)
    t_vae = TVAE(block_out_channels=WIDE_VAE)
    t_vae.load_state_dict(timp.vae_from_jax(vp), strict=True)
    z = _init(10, 1) * 0.18215

    def j_decode():
        return np.asarray(vae.apply({"params": vp}, jnp.asarray(z) / 0.18215,
                                    method=vae.decode))

    codes = ForcedCodes()
    with mock.patch.object(jq, "_quantize_activation",
                           codes.record(jq._quantize_activation)), \
            jq.override("w8a8"):
        want = j_decode()
    decode = tbench.make_decoder(t_vae.eval())
    with mock.patch.object(tq, "quantize_activation",
                           codes.force(tq.quantize_activation)):
        got = _nhwc(decode(_nchw(z), "w8a8"))
    codes.check_all_used()
    # every wide layer quantized: 2 convs in each of 8 resnets, the one
    # 1×1 shortcut (128 → 64), the upsample conv, the mid attention's 4
    # projections
    assert len(codes.codes) == 22
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def _ada_case():
    rng = np.random.default_rng(0)
    shapes = {"dense": (256, 160), "thin": (200, 100), "bias": (64,),
              "conv": (8, 3, 3, 140), "cube": (130, 300, 3),
              "zeros": (150, 130)}
    params = {k: (0.0 if k == "zeros" else 0.1)
              * rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (0.01 if i == 1 else 0.3)
              * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for i in range(3)]
    return params, grads


def test_factored_dims_match_optax():
    from optax._src.factorized import _factored_dims
    for shape in [(256, 160), (200, 100), (64,), (8, 3, 3, 140),
                  (130, 300, 3), (128, 128), (640, 320, 3, 3), (127, 512)]:
        assert factored_dims(shape) == _factored_dims(shape, True, 128)


def test_adafactor_matches_optax_chain():
    """Three steps (the first and last clipped, the middle one not) on
    leaves factored (both of two dims ≥ 128) and not: parameters within
    1e-6 of their largest value; the second-moment statistics, fp32 means
    summed in another order, within 1e-5 relative."""
    params, grads = _ada_case()
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adafactor(1e-4))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Adafactor(1e-4)
    ts = opt.init(tp)
    for g in grads:
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, updates)
        assert opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                          ts, tp)
        for k in params:
            want = np.asarray(jp[k])
            assert np.abs(tp[k].numpy() - want).max() <= \
                1e-6 * max(np.abs(want).max(), 1e-3), k
    factored = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: hasattr(s, "v_row")) if hasattr(s, "v_row"))
    assert ts["count"] == int(factored.count) == 3
    moments = dict(zip(params, ts["moments"]))  # tree_leaves order
    for k in params:
        m = moments[k]
        for name in m:
            np.testing.assert_allclose(m[name].numpy(),
                                       np.asarray(getattr(factored, name)[k]),
                                       rtol=1e-5, err_msg=f"{k} {name}")
    assert set(moments["dense"]) == {"v_row", "v_col"}
    assert set(moments["thin"]) == {"v"}


# ---------------------------------------------------------------------------
# The training benches at a tiny size
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_factories(monkeypatch):
    """The full-size factories swapped for the tiny ones (CPU)."""
    def unet(device):
        return tbench._filled(tiny_condition_unet(device="meta"), device,
                              torch.Generator(device).manual_seed(0)), 32

    monkeypatch.setattr(tbench, "sd_unet", unet)
    monkeypatch.setattr(tbench, "sd_stack", lambda device: load_sd_stack(
        tiny=True, device=device))
    monkeypatch.setattr(tbench, "classifier_config", lambda size, batch: (
        ClassificationConfig(image_size=size, batch_size=batch,
                             variant="tiny")))


def _finite_positive(d: dict, *keys):
    for k in keys:
        assert math.isfinite(d[k]) and d[k] > 0, (k, d[k])


def test_training_benches_at_a_tiny_size(tiny_factories):
    """Each bench's keys and finite, positive rates (the tiny classifier
    variant, the tiny stack and UNet, 32 px)."""
    cls = tbench.bench_classifier_train(batch_size=4, image_size=32,
                                        repeats=1, chain=2, device="cpu")
    assert set(cls) == {"train_images_per_sec"}
    _finite_positive(cls, "train_images_per_sec")
    lora = tbench.bench_sd_lora_train(batch_size=2, image_size=32, repeats=1,
                                      chain=2, device="cpu")
    assert set(lora) == {"sd_lora_train_images_per_sec", "compile_sec"}
    _finite_positive(lora, *lora)
    dist = tbench.bench_distill_train(batch_size=2, image_size=32, repeats=1,
                                      chain=2, device="cpu")
    assert set(dist) == {"distill_train_images_per_sec", "sec_per_step",
                         "batch", "optimizer", "compile_sec",
                         "minutes_per_2000step_phase", "fallbacks"}
    _finite_positive(dist, "distill_train_images_per_sec", "sec_per_step")
    assert (dist["batch"], dist["optimizer"], dist["fallbacks"]) == \
        (2, "adamw", [])


def test_distill_oom_ladder(tiny_factories, monkeypatch):
    """torch.OutOfMemoryError (and nothing else) moves the bench down the
    ladder: adamw → adafactor at the same batch, recorded in fallbacks."""
    make = tbench.make_distill_optimizer
    tried = []

    def optimizer(name):
        tried.append(name)
        if name == "adamw":
            raise torch.OutOfMemoryError("CUDA out of memory (fake)")
        return make(name)

    monkeypatch.setattr(tbench, "make_distill_optimizer", optimizer)
    out = tbench.bench_distill_train(batch_size=2, image_size=32, repeats=1,
                                     chain=2, device="cpu")
    assert tried == ["adamw", "adafactor"]
    assert (out["optimizer"], out["batch"], out["fallbacks"]) == \
        ("adafactor", 2, ["adamw@2: OOM"])
    _finite_positive(out, "distill_train_images_per_sec")

    def always_oom(name):
        raise torch.OutOfMemoryError("fake")

    monkeypatch.setattr(tbench, "make_distill_optimizer", always_oom)
    with pytest.raises(RuntimeError, match="OOM at every config"):
        tbench.bench_distill_train(batch_size=4, image_size=32, device="cpu")

    def broken(name):
        raise RuntimeError("not an OOM")

    monkeypatch.setattr(tbench, "make_distill_optimizer", broken)
    with pytest.raises(RuntimeError, match="not an OOM"):
        tbench.bench_distill_train(batch_size=2, image_size=32, device="cpu")


def test_sync_census_counts_a_step_by_difference():
    """tools/sync_census: the calls a step makes are the longer run's less
    the shorter's over the extra steps, by line; the build's and the
    fetches' lines, equal in both runs, drop out."""
    from collections import Counter

    from polyp_tpu_torch.tools import sync_census

    short = Counter({"train/sd_finetune.py:258": 4, "cli/bench.py:464": 2,
                     "models/build.py:10": 7})
    long = Counter({"train/sd_finetune.py:258": 8, "cli/bench.py:464": 2,
                    "models/build.py:10": 7, "diffusion/schedule.py:61": 4})
    assert sync_census.per_step(short, long, 4) == {
        "diffusion/schedule.py:61": 1.0, "train/sd_finetune.py:258": 1.0}
    assert sync_census._where("/x/polyp_tpu_torch/train/distill.py", 5) == \
        "train/distill.py:5"
    assert sync_census._where("/usr/lib/python3/site.py", 7) == "site.py:7"
