"""The port's serving slice on the CPU: `generate_batch` against the JAX
package's, the coalescing contract, the pipelined `generate_to_dir`, the
PNG encoder, the seeding contracts, and `GenerationService` and its HTTP
handler, each case of tests/test_fid_serve.py:131-700 on the port's
service, with a fake torch sampler. Every wait on a thread has a timeout.
"""

from __future__ import annotations

import base64
import io
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from polyp_tpu.pipeline import StableDiffusionSampler as JSampler
from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu_torch import pipeline as tpipe
from polyp_tpu_torch import serve as serve_mod
from polyp_tpu_torch.cli.common import load_sd_stack
from polyp_tpu_torch.data import native as tnative
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.ops import conv as tconv
from polyp_tpu_torch.serve import (
    DeadlineExceeded,
    GenerationService,
    ServiceOverloaded,
    serve,
)
from polyp_tpu_torch.tools import bench_serve
from polyp_tpu_torch.utils import rng
from test_torch_port_pipeline import SD_SCHEDULE, tiny_stacks  # noqa: F401
from _torch_threads import _one_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# generate_batch
# ---------------------------------------------------------------------------

def test_generate_batch_matches_jax(tiny_stacks, monkeypatch):  # noqa: F811
    """Two prompts padded to 4 through the default sampler (UniPC, CFG
    7.5) at 2 steps, 32px: JAX's generate_batch vs the port's, the port fed
    JAX's per-sample latents (vmapped normal of each key, NHWC → NCHW).
    Tolerance 5e-3 on images in [-1, 1], as test_whole_slice_matches_jax
    (CFG amplifies fp32 rounding, then the VAE decodes)."""
    unet, up, vae, vp, text, tp, tok = tiny_stacks["jax"]
    t_unet, t_vae, t_text, t_tok = tiny_stacks["torch"]
    kw = dict(image_size=32, num_steps=2, guidance_scale=7.5)
    j = JSampler(unet, up, vae, vp, text, tp, tok,
                 jsched.DiffusionSchedule.create(**SD_SCHEDULE), **kw)
    t = tpipe.StableDiffusionSampler(
        t_unet, t_vae, t_text, t_tok,
        tsched.DiffusionSchedule.create(**SD_SCHEDULE), **kw)
    prompts = ["a colonoscopy image of an adenomatous polyp", "a polyp"]
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(4)]
    want = np.asarray(j.generate_batch(prompts, keys, pad_to=4))
    latents = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (4, 4, 4), jnp.float32))(jnp.stack(keys)))
    fed = []

    def jax_latents(sample_ids):
        fed.append(list(sample_ids))
        return (torch.from_numpy(latents.transpose(0, 3, 1, 2).copy()),
                torch.Generator())

    monkeypatch.setattr(t, "draw_latents", jax_latents)
    got = t.generate_batch(prompts, [(3, 0), (4, 0)], pad_to=4)
    assert fed == [[(3, 0), (4, 0)]]
    assert got.shape == (2, 3, 32, 32) and want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=5e-3, atol=5e-3)


@pytest.fixture(scope="module")
def port_sampler():
    """The port's tiny stack (fp32, CPU, seed 0) at its default sampler
    (UniPC, CFG 7.5), 2 steps, 16px."""
    stack = load_sd_stack(None, dtype=torch.float32, tiny=True, device="cpu")
    return tpipe.StableDiffusionSampler(
        stack.unet, stack.vae, stack.text, stack.tokenizer,
        tsched.DiffusionSchedule.create(**SD_SCHEDULE), image_size=16,
        num_steps=2)


def test_coalescing_invariance_at_fixed_pad(port_sampler):
    """At a fixed pad_to a sample is bit-identical solo and coalesced, and
    in either slot of the launch; distinct (prompt, pair) samples
    differ."""
    s = port_sampler
    solo = s.generate_batch(["a colon polyp"], [(3, 0)], pad_to=4)
    pair = s.generate_batch(["a colon polyp", "something else"],
                            [(3, 0), (5, 1)], pad_to=4)
    swapped = s.generate_batch(["something else", "a colon polyp"],
                               [(5, 1), (3, 0)], pad_to=4)
    assert solo.shape == (1, 3, 16, 16) and pair.shape == (2, 3, 16, 16)
    assert torch.equal(pair[0], solo[0])
    assert torch.equal(swapped[1], solo[0])
    assert torch.equal(swapped[0], pair[1])
    assert not torch.allclose(pair[0], pair[1])


def test_generate_batch_pads_with_the_last_row_and_slices(port_sampler,
                                                          monkeypatch):
    """The launch sees pad_to rows, the pad rows repeating the last row's
    cond and latents; the caller gets len(prompts) rows. A pad_to below
    the batch is no pad."""
    s = port_sampler
    seen = []
    real = s.generate_rows

    def spy(cond, latents, generator=None):
        seen.append((cond.clone(), latents.clone()))
        return real(cond, latents, generator)

    monkeypatch.setattr(s, "generate_rows", spy)
    out = s.generate_batch(["a", "b"], [(1, 0), (2, 0)], pad_to=5)
    cond, latents = seen[-1]
    assert out.shape[0] == 2 and cond.shape[0] == latents.shape[0] == 5
    for row in (2, 3, 4):
        assert torch.equal(cond[row], cond[1])
        assert torch.equal(latents[row], latents[1])
    assert torch.equal(cond[0], s.encode_prompt("a")[0])
    assert s.generate_batch(["a", "b", "c"], [(1, 0)] * 3,
                            pad_to=2).shape[0] == 3
    assert seen[-1][0].shape[0] == 3


def test_draw_latents_follow_the_request_generators(port_sampler):
    latents, stream = port_sampler.draw_latents([(7, 0), (7, 1)])
    for row, index in enumerate((0, 1)):
        want = torch.randn((4, 2, 2),
                           generator=rng.request_generator(7, index, "cpu"))
        assert torch.equal(latents[row], want)
    # the stream continues the first pair's generator past its latents
    gen = rng.request_generator(7, 0, "cpu")
    torch.randn((4, 2, 2), generator=gen)
    assert torch.equal(torch.randn(3, generator=stream),
                       torch.randn(3, generator=gen))


def test_generate_batch_refuses_mismatched_ids(port_sampler):
    with pytest.raises(ValueError, match="sample ids"):
        port_sampler.generate_batch(["a", "b"], [(0, 0)])
    with pytest.raises(ValueError, match="at least one"):
        port_sampler.generate_batch([], [])


@pytest.mark.parametrize("stride,padding,bias", [
    ((1, 1), (1, 1), True), ((2, 2), (1, 1), False), ((1, 1), (0, 0), True)])
def test_conv2d_unfold_is_the_convolution(stride, padding, bias):
    """The patch-matrix form of a conv against F.conv2d in fp32: the same
    sums in another order (rtol 1e-5 of max |y|)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, 9, 9, generator=g)
    w = torch.randn(6, 8, 3, 3, generator=g)
    b = torch.randn(6, generator=g) if bias else None
    want = torch.nn.functional.conv2d(x, w, b, stride, padding)
    got = tconv.conv2d_unfold(x, w, b, stride, padding)
    assert got.shape == want.shape and got.is_contiguous()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_slot_invariant_region_probes_each_shape(monkeypatch):
    """Outside the region a conv is F.conv2d. Inside, a shape whose direct
    convolution gives slots different bits (here a fake one, as cuDNN's
    bf16 3×3 convs at small maps do on the H100) runs as the patch-matrix
    product, whose slots agree; where neither form does, the conv
    raises."""
    real = torch.nn.functional.conv2d

    def slot_dependent(x, w, b=None, *args):
        y = real(x, w, b, *args)
        return y + 1e-3 * torch.arange(y.shape[0]).view(-1, 1, 1, 1)

    monkeypatch.setattr(tconv, "_PLANS", {})
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 4, 6, 6, generator=g).expand(4, 4, 6, 6).contiguous()
    w = torch.randn(5, 4, 3, 3, generator=g)
    args = (w, None, (1, 1), (1, 1))
    assert torch.equal(tconv.conv2d(x, *args), real(x, *args))
    with tconv.slot_invariant_region():
        assert torch.equal(tconv.conv2d(x, *args), real(x, *args))
    assert list(tconv._PLANS.values()) == ["direct"]
    monkeypatch.setattr(torch.nn.functional, "conv2d", slot_dependent)
    monkeypatch.setattr(tconv, "_PLANS", {})
    with tconv.slot_invariant_region():
        y = tconv.conv2d(x, *args)
    assert list(tconv._PLANS.values()) == ["unfold"]
    assert all(torch.equal(y[0], y[i]) for i in range(4))
    assert not torch.equal(tconv.conv2d(x, *args)[0],
                           tconv.conv2d(x, *args)[1])
    monkeypatch.setattr(tconv, "conv2d_unfold", lambda *a: slot_dependent(
        x, w, None, (1, 1), (1, 1)))
    monkeypatch.setattr(tconv, "_PLANS", {})
    with tconv.slot_invariant_region(), pytest.raises(
            RuntimeError, match="no slot-invariant convolution"):
        tconv.conv2d(x, *args)


# ---------------------------------------------------------------------------
# seeds, uint8, PNG encoding
# ---------------------------------------------------------------------------

def test_request_seeds_are_distinct_and_apart_from_batch_seeds():
    grid = [(s, i) for s in range(-3, 500) for i in range(8)]
    seeds = {rng.request_seed(s, i) for s, i in grid}
    assert len(seeds) == len(grid)
    assert not seeds & {rng.batch_seed(s, i) for s in range(100)
                        for i in range(100)}
    assert all(0 <= x < 2 ** 63 for x in seeds)
    assert rng.request_seed(5, 1) == rng.request_seed(5, 1)
    a = torch.rand(4, generator=rng.batch_generator(10, 2, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=torch.Generator()
                                     .manual_seed(12)))


def test_images_uint8_is_the_former_host_conversion():
    """On-device uint8 (round half to even in fp32) equals the former
    host formula bit for bit, ties and clamped values included."""
    ties = (torch.arange(256.0) + 0.5) / 255 * 2 - 1
    x = torch.cat([torch.linspace(-1.3, 1.3, 4000), ties,
                   torch.randn(3000)])[:6912].reshape(3, 3, 24, 32)
    former = ((x.float() / 2 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
              .numpy() * 255).round().astype(np.uint8)
    np.testing.assert_array_equal(tpipe.to_uint8(x), former)
    np.testing.assert_array_equal(tpipe.fetch_uint8(x)(), former)
    assert tpipe.images_uint8(x).dtype == torch.uint8


@pytest.fixture
def native_png(tmp_path, monkeypatch):
    """native/png_decode.cpp built into tmp_path as the port's library
    (the repository's Makefile recipe), or a skip where g++ or libpng is
    missing."""
    lib = tmp_path / "libpolyp_png.so"
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native PNG encoder")
    proc = subprocess.run(
        ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(lib),
         str(ROOT / "native" / "png_decode.cpp"), "-lpng"],
        capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip(f"native PNG encoder did not build: {proc.stderr[-300:]}")
    monkeypatch.setattr(tnative, "LIBRARY", lib)
    return lib


def test_png_encoder_choice_and_refusals(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "LIBRARY", tmp_path / "absent.so")
    assert tnative.png_encoder() == tnative.png_encoder("pil") == "pil"
    with pytest.raises(RuntimeError, match="make -C native"):
        tnative.png_encoder("native")
    with pytest.raises(ValueError, match="unknown PNG encoder"):
        tnative.png_encoder("jpeg")
    with pytest.raises(ValueError, match="HWC RGB"):
        tnative.encode_png(np.zeros((4, 4), np.uint8))


def test_native_and_pil_encoders_decode_to_the_same_pixels(native_png):
    img = np.random.default_rng(0).integers(0, 256, (24, 40, 3), np.uint8)
    assert tnative.png_encoder() == "native"
    for level in (1, 4):
        native = tnative.encode_png(img, level=level)
        pil = tnative.encode_png(img, level=level, encoder="pil")
        assert native != pil
        for data in (native, pil):
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(data))), img)


# ---------------------------------------------------------------------------
# generate_to_dir
# ---------------------------------------------------------------------------

def _stub_sampler(batch_size, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(batch_size, 3, 8, 8, generator=g) * 2 - 1


@pytest.mark.parametrize("encoder", ["pil", "native"])
def test_generate_to_dir_writes_the_to_uint8_pixels(tmp_path, encoder,
                                                    request, monkeypatch):
    """Each PNG decodes to to_uint8 of its batch, by either encoder; names
    are 1-based across batches and progress follows each batch."""
    if encoder == "native":
        request.getfixturevalue("native_png")
    else:
        monkeypatch.setattr(tnative, "LIBRARY", tmp_path / "absent.so")
    done = []
    out = tmp_path / "out"
    assert tpipe.generate_to_dir(_stub_sampler, 5, out,
                                 eval_batch_size=2, seed=4,
                                 progress=lambda d, n: done.append((d, n))
                                 ) == 5
    assert tnative.png_encoder() == encoder
    assert done == [(2, 5), (4, 5), (5, 5)]
    for b, (first, bs) in enumerate(((0, 2), (2, 2), (4, 1))):
        want = tpipe.to_uint8(_stub_sampler(bs, 4 + b))
        for i in range(bs):
            got = np.asarray(Image.open(out / f"{first + i + 1}.png"))
            np.testing.assert_array_equal(got, want[i])


def test_generate_to_dir_samples_next_batch_before_encoding(tmp_path,
                                                            monkeypatch):
    """Batch i+1's sampler is called before any image of batch i is
    encoded, and the files are written in order."""
    events = []
    lock = threading.Lock()

    def sampler(bs, seed):
        with lock:
            events.append(("sample", seed))
        return _stub_sampler(bs, seed)

    real = tpipe.encode_png

    def encode(img, level=1):
        with lock:
            events.append(("encode", int(img[0, 0, 0])))
        return real(img, level=level)

    monkeypatch.setattr(tpipe, "encode_png", encode)
    tpipe.generate_to_dir(sampler, 7, tmp_path, eval_batch_size=2, seed=0)
    samples = [i for i, e in enumerate(events) if e[0] == "sample"]
    encodes = [i for i, e in enumerate(events) if e[0] == "encode"]
    assert len(samples) == 4 and len(encodes) == 7
    # the first encode of batch b comes after batch b+1 was sampled
    firsts = [encodes[0], encodes[2], encodes[4]]
    for b, first in enumerate(firsts):
        assert samples[b + 1] < first
    order = [int(np.asarray(Image.open(tmp_path / f"{i}.png"))[0, 0, 0])
             for i in range(1, 8)]
    assert order == [e[1] for e in events if e[0] == "encode"]


def test_top_up_regenerates_identical_files(tmp_path):
    full = tmp_path / "full"
    tpipe.generate_to_dir(_stub_sampler, 7, full, eval_batch_size=3, seed=9)
    part = tmp_path / "part"
    tpipe.generate_to_dir(_stub_sampler, 4, part, eval_batch_size=3, seed=9)
    (part / "4.png").unlink()
    assert tpipe.top_up_samples(_stub_sampler, 7, part, 3, 9) == 4
    for i in range(1, 8):
        assert (full / f"{i}.png").read_bytes() == \
            (part / f"{i}.png").read_bytes()


def test_generate_to_dir_raises_an_encode_failure(tmp_path, monkeypatch):
    def broken(img, level=1):
        raise OSError("disk full")

    monkeypatch.setattr(tpipe, "encode_png", broken)
    with pytest.raises(OSError, match="disk full"):
        tpipe.generate_to_dir(_stub_sampler, 4, tmp_path, eval_batch_size=2)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

def _fake_batch_sampler(prompts, sample_ids):
    """MultiPromptSampler stand-in: each sample is a function of its own
    (prompt, (seed, index)), the contract generate_batch gives."""
    return torch.stack([
        torch.rand(3, 8, 8, generator=rng.request_generator(s, j, "cpu"))
        * 2 - 1 + (0.1 if "polyp" in p else 0.0)
        for p, (s, j) in zip(prompts, sample_ids)])


def _post(url, payload, path="/generate"):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _concurrent(svc, requests, timeout=30):
    """Submit requests from parallel threads; results in order."""
    results = [None] * len(requests)
    errors = []

    def run(i, kwargs):
        try:
            results[i] = svc.generate(**kwargs)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, kw))
               for i, kw in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


class TestServer:
    @pytest.fixture(scope="class")
    def server(self):
        service = GenerationService(_fake_batch_sampler, max_batch=4,
                                    warm_prompt="warm")
        server = serve(service, port=0)
        yield f"http://127.0.0.1:{server.server_address[1]}"
        server.shutdown()
        service.close()

    def test_healthz(self, server):
        with urllib.request.urlopen(server + "/healthz", timeout=30) as resp:
            body = json.loads(resp.read())
        assert body["status"] == "ok" and body["warm"]
        assert body["models"] == ["polyp-sd"] and body["max_pending"] == 64
        assert body["stats"]["launches"] >= 1

    def test_generate_returns_decodable_pngs(self, server):
        status, body, _ = _post(server, {"prompt": "a polyp",
                                         "num_images": 2, "seed": 5})
        assert status == 200 and len(body["images"]) == 2
        img = Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
        assert img.size == (8, 8)
        want = tpipe.to_uint8(_fake_batch_sampler(["a polyp"], [(5, 0)]))[0]
        np.testing.assert_array_equal(np.asarray(img), want)
        assert (body["prompt"], body["seed"], body["model"]) == \
            ("a polyp", 5, "polyp-sd")

    def test_generate_deterministic_per_seed(self, server):
        _, a, _ = _post(server, {"prompt": "x", "num_images": 1, "seed": 9})
        _, b, _ = _post(server, {"prompt": "x", "num_images": 1, "seed": 9})
        assert a["images"] == b["images"]

    @pytest.mark.parametrize("payload,match", [
        ({"prompt": "x", "num_images": 99}, "num_images"),
        ({"prompt": "x", "num_images": 0}, "num_images"),
        ({"prompt": "x", "model": "nope"}, "unknown model")])
    def test_bad_request_rejected(self, server, payload, match):
        status, body, _ = _post(server, payload)
        assert status == 400 and match in body["error"]

    @pytest.mark.parametrize("method", ["GET", "POST"])
    def test_unknown_route_404(self, server, method):
        req = urllib.request.Request(
            server + "/nope", b"{}" if method == "POST" else None,
            method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404


class TestCoalescing:
    """Concurrent requests ride one launch, results do not depend on what
    they were batched with, and a request that does not fit heads the next
    launch instead of splitting."""

    def _service(self, max_batch=4, window=0.5, sampler=None):
        calls = []

        def counting(prompts, sample_ids):
            calls.append((list(prompts), list(sample_ids)))
            return (sampler or _fake_batch_sampler)(prompts, sample_ids)

        return GenerationService(counting, max_batch=max_batch,
                                 batch_window_s=window), calls

    def test_concurrent_requests_share_one_launch(self):
        svc, calls = self._service()
        try:
            a, b = _concurrent(svc, [
                dict(prompt="a polyp", num_images=1, seed=1),
                dict(prompt="another", num_images=1, seed=2)])
            assert a["batched_samples"] == b["batched_samples"] == 2
            assert len(calls) == 1 and len(calls[0][0]) == 2
            assert sorted(calls[0][1]) == [(1, 0), (2, 0)]
            assert svc.snapshot()["launches"] == 1
            assert svc.snapshot()["coalesced_samples"] == 2
        finally:
            svc.close()

    def test_result_independent_of_coalescing(self):
        svc, _ = self._service()
        try:
            solo = svc.generate("a polyp", 2, seed=7)
            a, _b = _concurrent(svc, [
                dict(prompt="a polyp", num_images=2, seed=7),
                dict(prompt="noise", num_images=2, seed=3)])
            assert a["batched_samples"] == 4
            assert solo["images"] == a["images"]
        finally:
            svc.close()

    def test_oversize_spill_heads_next_launch(self):
        svc, calls = self._service(max_batch=4)
        try:
            a, b = _concurrent(svc, [
                dict(prompt="big", num_images=3, seed=1),
                dict(prompt="spill", num_images=2, seed=2)])
            assert sorted(len(c[0]) for c in calls) == [2, 3]
            assert len(a["images"]) == 3 and len(b["images"]) == 2
        finally:
            svc.close()

    def test_window_zero_disables_coalescing(self):
        svc, calls = self._service(window=0.0)
        try:
            _concurrent(svc, [dict(prompt="x", num_images=1, seed=1),
                              dict(prompt="y", num_images=1, seed=2)])
            assert len(calls) == 2
            assert svc.snapshot()["coalesced_samples"] == 0
        finally:
            svc.close()

    @pytest.mark.parametrize("where", ["launch", "readback"])
    def test_sampler_error_propagates(self, where, monkeypatch):
        """A failure when the launch is queued, or when its images are
        waited for (where a failure on the card surfaces), reaches every
        request of the launch; the service keeps serving."""
        def boom(prompts, sample_ids):
            raise RuntimeError("kernel on fire")

        if where == "readback":
            def failing_fetch(images):
                def wait():
                    raise RuntimeError("kernel on fire")
                return wait
            monkeypatch.setattr(serve_mod, "fetch_uint8", failing_fetch)
        svc, _ = self._service(
            sampler=boom if where == "launch" else None)
        try:
            with pytest.raises(RuntimeError, match="kernel on fire"):
                svc.generate("x", 1)
            monkeypatch.undo()
            assert svc.snapshot()["launches"] == 0
        finally:
            svc.close()

    def test_per_sample_ids_decouple_num_images_split(self):
        """One request of 2 images == two requests of 1 image, because
        sample j of a request is seeded by (seed, j); other seeds
        differ."""
        svc, _ = self._service(window=0.0)
        try:
            both = svc.generate("p", 2, seed=11)
            first = svc.generate("p", 1, seed=11)
            assert both["images"][0] == first["images"][0]
            assert both["images"][1] != first["images"][0]
            other = svc.generate("p", 1, seed=12)
            assert other["images"][0] != first["images"][0]
        finally:
            svc.close()

    def test_dispatcher_runs_the_sampler_without_grad(self):
        """Grad mode is thread-local: the dispatcher turns it off itself."""
        modes = []

        def sampler(prompts, sample_ids):
            modes.append(torch.is_grad_enabled())
            return _fake_batch_sampler(prompts, sample_ids)

        assert torch.is_grad_enabled()
        svc, _ = self._service(window=0.0, sampler=sampler)
        try:
            svc.generate("p", 1)
        finally:
            svc.close()
        assert modes == [False]


class TestPipelining:
    """pipeline_depth: at 2 the dispatcher queues launch B while launch A's
    images are still being fetched; at 1 the semaphore serialises launch
    and fetch. The fetch is made observable by a sleep in it."""

    def _svc(self, monkeypatch, depth):
        events = []
        real = serve_mod.fetch_uint8

        def slow_fetch(images):
            wait = real(images)

            def slow():
                events.append(("readback_start", time.perf_counter()))
                time.sleep(0.4)
                out = wait()
                events.append(("readback_end", time.perf_counter()))
                return out
            return slow

        monkeypatch.setattr(serve_mod, "fetch_uint8", slow_fetch)

        def sampler(prompts, sample_ids):
            events.append(("launch", time.perf_counter()))
            return _fake_batch_sampler(prompts, sample_ids)

        # max_batch=1 and window 0: every request is its own launch
        svc = GenerationService(sampler, max_batch=1, batch_window_s=0.0,
                                pipeline_depth=depth)
        return svc, events

    def _two_staggered(self, svc):
        threads = [threading.Thread(target=svc.generate, args=("p", 1),
                                    kwargs={"seed": i}) for i in (1, 2)]
        threads[0].start()
        time.sleep(0.1)  # A is mid-fetch (0.4 s) when B arrives
        threads[1].start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_depth_orders_launch_and_fetch(self, monkeypatch, depth):
        svc, events = self._svc(monkeypatch, depth)
        try:
            self._two_staggered(svc)
        finally:
            svc.close()
        launches = [ts for k, ts in events if k == "launch"]
        ends = [ts for k, ts in events if k == "readback_end"]
        assert len(launches) == 2 and len(ends) == 2
        if depth == 2:
            assert launches[1] < ends[0]   # B launched during A's fetch
        else:
            assert launches[1] >= ends[0]  # B waited for A's fetch
        assert svc.snapshot()["launches"] == 2

    def test_pipelined_results_stay_deterministic(self, monkeypatch):
        svc, _ = self._svc(monkeypatch, depth=2)
        try:
            solo = svc.generate("p", 1, seed=7)
            got = {}

            def run(name, seed):
                got[name] = svc.generate("p", 1, seed=seed)

            threads = [threading.Thread(target=run, args=("a", 7)),
                       threading.Thread(target=run, args=("b", 3))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
        finally:
            svc.close()
        assert got["a"]["images"] == solo["images"]
        assert got["b"]["images"] != solo["images"]


class TestBenchServe:
    """The load generators: stats over the window alone (warm-up launches
    excluded), occupancy = requests a launch, shed and expired counts."""

    def test_run_load_stats(self):
        svc = GenerationService(_fake_batch_sampler, max_batch=4,
                                warm_prompt="warm", batch_window_s=0.02)
        try:
            svc.generate("pre-existing traffic", 1, seed=0)
            stats = bench_serve.run_load(svc, clients=3, duration=1.0)
        finally:
            svc.close()
        assert stats["requests"] > 0
        assert 0 < stats["launches"] <= stats["requests"]
        assert stats["throughput_samples_per_s"] > 0
        assert 0 < stats["p50_s"] <= stats["p95_s"] <= stats["p99_s"]
        assert stats["mean_batch_occupancy"] == pytest.approx(
            stats["requests"] / stats["launches"])

    def test_run_load_over_http(self):
        svc = GenerationService(_fake_batch_sampler, max_batch=4,
                                batch_window_s=0.02)
        server = serve(svc, port=0)
        try:
            stats = bench_serve.run_load(svc, clients=2, duration=0.5,
                                         http_port=server.server_address[1])
        finally:
            server.shutdown()
            svc.close()
        assert stats["requests"] > 0 and stats["launches"] > 0

    def test_percentile_edges(self):
        assert bench_serve.percentile([1.0], 0.95) == 1.0
        vals = [float(i) for i in range(100)]
        assert bench_serve.percentile(vals, 0.0) == 0.0
        assert bench_serve.percentile(vals, 1.0) == 99.0
        assert abs(bench_serve.percentile(vals, 0.5) - 50.0) <= 1.0
        assert np.isnan(bench_serve.percentile([], 0.5))

    def test_run_multimodel_load(self):
        svc = GenerationService({"A": _fake_batch_sampler,
                                 "B": _fake_batch_sampler}, max_batch=4,
                                batch_window_s=0.02)
        try:
            out = bench_serve.run_multimodel_load(
                svc, 0.5, [("A", "p"), ("A", "p"), ("B", "q")])
        finally:
            svc.close()
        assert out["clients_by_model"] == {"A": 2, "B": 1}
        for m in ("A", "B"):
            assert out["per_model"][m]["requests"] > 0
            assert out["per_model"][m]["launches"] > 0
        assert out["throughput_samples_per_s"] > 0

    @pytest.mark.parametrize("bound,timeout_s", [(2, None), (None, 0.05)])
    def test_run_overload_counts_shed_and_expired(self, bound, timeout_s):
        """Arrivals at 40/s against a sampler that takes 0.1 s a launch
        (max_batch 1): a bound of 2 sheds, a 50 ms queue-wait deadline
        expires; every offered request is accounted for."""
        def slow(prompts, sample_ids):
            time.sleep(0.1)
            return _fake_batch_sampler(prompts, sample_ids)

        svc = GenerationService(slow, max_batch=1, batch_window_s=0.0,
                                max_pending=bound)
        try:
            out = bench_serve.run_overload(svc, arrival_rate=40.0,
                                           duration=0.5, timeout_s=timeout_s)
        finally:
            svc.close()
        assert out["offered"] == 20
        assert out["accepted"] + out["shed"] + out["expired"] == 20
        assert out["accepted"] > 0
        if bound is not None:
            assert out["shed"] > 0 and out["expired"] == 0
        else:
            assert out["expired"] > 0 and out["shed"] == 0
        assert out["p50_s"] <= out["p95_s"] <= out["p99_s"] <= out["max_s"]


class TestMultiModel:
    """Same-model coalescing, cross-model isolation, FIFO across models,
    per-model stats."""

    def _service(self, window=0.5, max_batch=4):
        calls = []

        def tagged(tag):
            def sampler(prompts, sample_ids):
                calls.append((tag, list(prompts)))
                return _fake_batch_sampler(prompts, sample_ids) + (
                    0.01 if tag == "B" else 0.0)
            return sampler

        svc = GenerationService({"A": tagged("A"), "B": tagged("B")},
                                max_batch=max_batch, batch_window_s=window)
        return svc, calls

    def test_same_model_coalesces_cross_model_does_not(self):
        svc, calls = self._service()
        try:
            a1, a2, b1 = _concurrent(svc, [
                dict(prompt="p", num_images=1, seed=1, model="A"),
                dict(prompt="q", num_images=1, seed=2, model="A"),
                dict(prompt="r", num_images=1, seed=3, model="B")], 60)
            assert a1["model"] == a2["model"] == "A" and b1["model"] == "B"
            stats = svc.snapshot()
            assert stats["launches"] == 2
            assert stats["launches_by_model"] == {"A": 1, "B": 1}
            assert sorted(t for t, _ in calls) == ["A", "B"]
        finally:
            svc.close()

    def test_default_model_is_first_key(self):
        svc, _ = self._service(window=0.0)
        try:
            assert svc.generate("p", 1, seed=4)["model"] == "A"
        finally:
            svc.close()

    def test_unknown_model_rejected(self):
        svc, _ = self._service(window=0.0)
        try:
            with pytest.raises(ValueError, match="unknown model"):
                svc.generate("p", 1, model="nope")
        finally:
            svc.close()

    def test_result_independent_of_cross_model_traffic(self):
        svc, _ = self._service()
        try:
            solo = svc.generate("p", 2, seed=7, model="B")
            mixed = _concurrent(svc, [
                dict(prompt="p", num_images=2, seed=7, model="B"),
                dict(prompt="z", num_images=2, seed=8, model="A")], 60)[0]
            assert solo["images"] == mixed["images"]
        finally:
            svc.close()

    def test_models_are_served_in_arrival_order(self):
        """A (queued first) launches before B even when B's burst is
        larger."""
        svc, calls = self._service(window=0.2, max_batch=2)
        try:
            threads = [threading.Thread(
                target=svc.generate, args=("p", 1),
                kwargs={"seed": 0, "model": "A"})]
            threads[0].start()
            time.sleep(0.05)
            threads += [threading.Thread(
                target=svc.generate, args=("q", 1),
                kwargs={"seed": i, "model": "B"}) for i in range(4)]
            for t in threads[1:]:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        finally:
            svc.close()
        assert [t for t, _ in calls] == ["A", "B", "B"]

    def test_close_flushes_all_pending_models(self):
        svc, _ = self._service(window=0.2)
        results = []
        t = threading.Thread(target=lambda: results.append(
            svc.generate("p", 1, seed=1, model="B")))
        t.start()
        time.sleep(0.05)  # B waiting inside the window
        svc.close()
        t.join(timeout=30)
        assert not t.is_alive()
        assert results and results[0]["model"] == "B"


class TestAdmissionControl:
    """Requests past `max_pending` are shed with ServiceOverloaded,
    queue-wait deadlines expire with DeadlineExceeded, both surface as
    429 / 503 and in the stats."""

    def _blocking_service(self, max_pending, **kw):
        gate = threading.Event()
        started = threading.Event()

        def sampler(prompts, sample_ids):
            started.set()
            assert gate.wait(timeout=30), "test gate never opened"
            return _fake_batch_sampler(prompts, sample_ids)

        svc = GenerationService(sampler, max_batch=1, batch_window_s=0.0,
                                max_pending=max_pending, **kw)
        return svc, gate, started

    def _bg(self, svc, n, **kw):
        outs, errs = [], []

        def run(seed):
            try:
                outs.append(svc.generate("p", 1, seed=seed, **kw))
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        return threads, outs, errs

    def _wait_pending(self, svc, n):
        deadline = time.monotonic() + 5
        while svc._pending_count < n and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc._pending_count == n

    def _join(self, threads):
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)

    def test_shed_past_max_pending(self):
        svc, gate, started = self._blocking_service(max_pending=2)
        try:
            threads_a, outs_a, errs_a = self._bg(svc, 1)
            assert started.wait(timeout=10)   # A holds the card
            threads_bc, outs_bc, errs_bc = self._bg(svc, 2)
            self._wait_pending(svc, 2)        # B and C fill the slots
            with pytest.raises(ServiceOverloaded, match="max_pending=2"):
                svc.generate("p", 1, seed=99)
            assert svc.snapshot()["shed"] == 1
            gate.set()
            self._join(threads_a + threads_bc)
            assert not errs_a and not errs_bc
            assert len(outs_a) + len(outs_bc) == 3
        finally:
            gate.set()
            svc.close()

    @pytest.mark.parametrize("timeout_s", [None, 5.0])
    def test_no_bound_and_no_expiry(self, timeout_s):
        """max_pending=None admits all; no deadline (or one not reached)
        expires none."""
        svc, gate, started = self._blocking_service(max_pending=None)
        try:
            threads, outs, errs = self._bg(svc, 6, timeout_s=timeout_s)
            assert started.wait(timeout=10)
            time.sleep(0.2)
            gate.set()
            self._join(threads)
            assert not errs and len(outs) == 6
            stats = svc.snapshot()
            assert stats["shed"] == stats["expired"] == 0
        finally:
            gate.set()
            svc.close()

    @pytest.mark.parametrize("default", [False, True])
    def test_queued_request_expires_after_timeout(self, default):
        """A 50 ms queue-wait deadline, per request or the service's
        default, expires a request queued behind a held launch; launched
        work completes."""
        kw = {"default_timeout_s": 0.05} if default else {}
        svc, gate, started = self._blocking_service(max_pending=None, **kw)
        try:
            threads_a, outs_a, _ = self._bg(svc, 1, timeout_s=5.0)
            assert started.wait(timeout=10)
            threads_b, outs_b, errs_b = self._bg(
                svc, 1, **({} if default else {"timeout_s": 0.05}))
            time.sleep(0.3)
            gate.set()
            self._join(threads_a + threads_b)
            assert len(outs_a) == 1 and not outs_b
            assert len(errs_b) == 1 and isinstance(errs_b[0],
                                                   DeadlineExceeded)
            assert svc.snapshot()["expired"] == 1
            assert svc._pending_count == 0
        finally:
            gate.set()
            svc.close()

    def test_http_429_503_500_and_stats(self):
        gate = threading.Event()
        started = threading.Event()

        def sampler(prompts, sample_ids):
            if prompts[0] == "fire":
                raise RuntimeError("kernel on fire")
            started.set()
            assert gate.wait(timeout=30)
            return _fake_batch_sampler(prompts, sample_ids)

        service = GenerationService(sampler, max_batch=1,
                                    batch_window_s=0.0, max_pending=1)
        server = serve(service, port=0)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        codes = []
        try:
            t1 = threading.Thread(target=lambda: codes.append(
                _post(url, {"prompt": "p"})[0]))
            t1.start()
            assert started.wait(timeout=10)
            t2 = threading.Thread(target=lambda: codes.append(
                _post(url, {"prompt": "p", "timeout_s": 0.05})[0]))
            t2.start()
            self._wait_pending(service, 1)
            status, body, headers = _post(url, {"prompt": "p"})
            assert status == 429 and headers.get("Retry-After") == "1"
            assert "max_pending" in body["error"]
            time.sleep(0.2)
            gate.set()
            self._join([t1, t2])
            assert sorted(codes) == [200, 503]
            status, body, _ = _post(url, {"prompt": "fire"})
            assert status == 500 and "kernel on fire" in body["error"]
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            assert health["max_pending"] == 1
            assert health["stats"]["shed"] == 1
            assert health["stats"]["expired"] == 1
            assert health["stats"]["launches"] == 1
        finally:
            gate.set()
            server.shutdown()
            service.close()


class _Guarded(dict):
    """A stats dict that records, at each write, whether the service's
    lock was held."""

    def __init__(self, lock, seen, items):
        super().__init__(items)
        self._guard, self._seen = lock, seen

    def __setitem__(self, key, value):
        self._seen.append((key, self._guard.locked()))
        super().__setitem__(key, value)


class TestOneLock:
    """One lock guards the pending count and every stats counter (the
    reference's shed counter took another lock, its serve.py:206)."""

    def test_every_counter_moves_under_the_lock(self):
        seen = []
        gate = threading.Event()

        def sampler(prompts, sample_ids):
            if prompts[0] == "hold":
                assert gate.wait(timeout=30)
            return _fake_batch_sampler(prompts, sample_ids)

        svc = GenerationService(sampler, max_batch=2, batch_window_s=0.3,
                                max_pending=2)
        svc.stats = _Guarded(svc._lock, seen, {
            **svc.stats, "launches_by_model": _Guarded(
                svc._lock, seen, svc.stats["launches_by_model"])})
        outcomes = []

        def call(prompt, n, **kw):
            try:
                svc.generate(prompt, n, **kw)
                outcomes.append((prompt, "ok"))
            except DeadlineExceeded:
                outcomes.append((prompt, "expired"))

        try:
            # requests, launches, launches_by_model, coalesced_samples
            _concurrent(svc, [dict(prompt="a", num_images=1, seed=1),
                              dict(prompt="b", num_images=1, seed=2)])
            # a full launch held on the card; behind it one request that
            # expires and one that waits, then one shed at the door
            threads = [threading.Thread(target=call, args=("hold", 2))]
            threads[0].start()
            time.sleep(0.1)
            threads += [threading.Thread(target=call, args=("late", 1),
                                         kwargs={"timeout_s": 0.01}),
                        threading.Thread(target=call, args=("wait", 1))]
            for t in threads[1:]:
                t.start()
            deadline = time.monotonic() + 5
            while svc._pending_count < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(ServiceOverloaded):
                svc.generate("shed", 1)
            time.sleep(0.05)
            gate.set()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        finally:
            gate.set()
            svc.close()
        assert sorted(outcomes) == [("hold", "ok"), ("late", "expired"),
                                    ("wait", "ok")]
        written = {key for key, _ in seen}
        assert written >= {"requests", "launches", "polyp-sd",
                           "coalesced_samples", "expired", "shed"}
        assert all(held for _, held in seen), seen
        stats = svc.snapshot()
        assert stats["shed"] == stats["expired"] == 1
        assert stats["launches"] == 3 and stats["requests"] == 4

    def test_snapshots_stay_consistent_under_contention(self):
        """16 client threads (more than the cores) with a shortened switch
        interval against a bound of 3: every snapshot has
        sum(launches_by_model) == launches, and at the end each request is
        answered, shed or expired exactly once."""
        svc = GenerationService({"A": _fake_batch_sampler,
                                 "B": _fake_batch_sampler}, max_batch=4,
                                batch_window_s=0.001, max_pending=3)
        outcomes = {"ok": 0, "shed": 0, "expired": 0}
        lock = threading.Lock()
        bad = []
        stop = threading.Event()

        def client(cid):
            for n in range(15):
                try:
                    svc.generate("p", 1, seed=n, model="AB"[cid % 2],
                                 timeout_s=0.05 if n % 3 == 0 else None)
                    key = "ok"
                except ServiceOverloaded:
                    key = "shed"
                except DeadlineExceeded:
                    key = "expired"
                with lock:
                    outcomes[key] += 1

        def reader():
            while not stop.is_set():
                s = svc.snapshot()
                if sum(s["launches_by_model"].values()) != s["launches"]:
                    bad.append(s)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            watcher = threading.Thread(target=reader)
            watcher.start()
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            stop.set()
            watcher.join(timeout=10)
            assert not any(t.is_alive() for t in threads + [watcher])
        finally:
            sys.setswitchinterval(old)
            stop.set()
            svc.close()
        stats = svc.snapshot()
        assert not bad
        assert sum(outcomes.values()) == 16 * 15
        assert stats["requests"] == outcomes["ok"]
        assert stats["shed"] == outcomes["shed"]
        assert stats["expired"] == outcomes["expired"]
        assert svc._pending_count == 0


def test_service_over_generate_batch_is_coalescing_invariant(port_sampler):
    """The product sampler behind the service (generate_batch at
    pad_to=max_batch): a request's PNGs are byte-identical solo and
    coalesced."""
    svc = GenerationService(
        lambda prompts, ids: port_sampler.generate_batch(prompts, ids,
                                                         pad_to=4),
        max_batch=4, batch_window_s=0.5)
    try:
        solo = svc.generate("a colon polyp", 1, seed=21)
        a, b = _concurrent(svc, [
            dict(prompt="something else", num_images=2, seed=3),
            dict(prompt="a colon polyp", num_images=1, seed=21)], 120)
    finally:
        svc.close()
    assert b["batched_samples"] == 3
    assert b["images"] == solo["images"]
    assert a["images"][0] != a["images"][1]


@pytest.mark.parametrize("argv", [
    ["--quantize", "promoted", "--distilled-dir", "runs/distill"],
    ["--quantize", "promoted"]])
def test_main_refuses_what_the_port_cannot_serve(argv, tmp_path,
                                                 monkeypatch):
    """--quantize promoted resolves through the port's own quant gate
    before any stack is built: under a verdict whose entries pass, the
    service factory gets the concrete mode and head (the distilled entry
    for --distilled-dir); under one whose entries are demoted, main exits
    naming the port's gate file and the factory is never reached."""
    from polyp_tpu_torch.ops import quant as tq

    entries = {"promoted": {"mode": "w8a8_static", "quant_fp_head": 5,
                            "quant_fp_tail": 0},
               "promoted_distilled": {"mode": "w8a8_static",
                                      "quant_fp_head": 0,
                                      "quant_fp_tail": 0}}
    built = []

    def factory(args):
        built.append((args.quantize, args.quant_fp_head, args.quant_fp_tail))
        raise KeyboardInterrupt  # stop before any stack

    monkeypatch.setattr(serve_mod, "service_from_args", factory)
    gate = tmp_path / "quant_gate.json"
    monkeypatch.setattr(tq, "GATE_PATH", gate)
    key = "promoted_distilled" if "--distilled-dir" in argv else "promoted"
    for passing in (True, False):
        gate.write_text(json.dumps({k: dict(v, gate_pass=passing)
                                    for k, v in entries.items()}))
        if passing:
            with pytest.raises(KeyboardInterrupt):
                serve_mod.main(argv)
            assert built.pop() == tuple(entries[key].values())
        else:
            with pytest.raises(SystemExit) as e:
                serve_mod.main(argv)
            assert str(gate) in str(e.value) and not built
