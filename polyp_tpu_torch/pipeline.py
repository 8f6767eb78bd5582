"""Generation pipeline: the twin of polyp_tpu/pipeline.py (the SD path
and the scratch path's PixelDiffusionSampler).

Prompt → CLIP → classifier-free-guided UNet sampling → VAE decode → uint8
PNGs, with quota-driven batching and idempotent top-up resume.

Distilled students (cli/distill_sd.py::make_student_sampler) run the same
sampler with folded guidance (`guidance_scale=None`: cond-only forwards at
1× batch), the trailing DDIM grid (`sampler_kwargs`), and optionally the
tiny decoder (`decoder=`, models/tiny_decoder.py) in place of the VAE.
`fused_mha=True` is the explicit form of the reference's POLYP_FUSED_MHA=1:
each UNet call of the sampler runs inside ops.attention.fused_mha_region,
where the UNet's attentions may take the fused MHA kernel
(ops/attention.py::use_fused_mha decides each call).

Determinism contracts (utils/rng.py): batch `i` of a quota run uses the
generator `torch.Generator(device).manual_seed(seed + i)`, so a top-up
resumes at batch `existing // eval_batch` and regenerates identical
batches; sample `j` of a served request uses
`request_generator(seed, j)` (`generate_batch`). torch's Philox and JAX's
threefry draw different noise from the same seed, so the two packages'
samples are not identical for one seed; given the same initial latents
(`init`) they agree to rounding (tests/test_torch_port_pipeline.py,
tests/test_torch_port_serve.py).

`generate_to_dir` is a one-batch pipeline: batch i+1's sampler is called
before batch i is fetched, and batch i is encoded and written on a worker
thread while batch i+1 samples.

int8 sampling (`quantize="w8a8_static"` or `"w8a8"`) quantizes the UNet
only; the VAE decode stays in the stack's dtype. `quant_fp_head` /
`quant_fp_tail` run the first / last steps in full precision (the
hybrid-precision trajectory, `_precision_split`). w8a8_static calibrates
its scales once per sampler on this stack's own CFG trajectory
(diffusion/calibrate.py, disk-cached by weight fingerprint).
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from polyp_tpu_torch.data.native import encode_png
from polyp_tpu_torch.diffusion import DiffusionSchedule, sample, with_cfg
from polyp_tpu_torch.diffusion.samplers import get_sampler
from polyp_tpu_torch.models.vae import SD_VAE_SCALING
from polyp_tpu_torch.ops import quant
from polyp_tpu_torch.ops.attention import fused_mha_region
from polyp_tpu_torch.ops.conv import slot_invariant_region
from polyp_tpu_torch.utils.rng import batch_seed, request_generator

# fn(batch_size, seed) -> float images in [-1, 1], NCHW
BatchSampler = Callable[[int, int], torch.Tensor]


def _precision_split(num_steps: int, quantize: str | None,
                     fp_head: int = 0, fp_tail: int = 0
                     ) -> tuple[str | None, tuple[int, int] | None]:
    """Resolve the hybrid-precision knobs (reference :59-81): `fp_head` /
    `fp_tail` first / final steps run full precision, the rest quantized.
    Returns (effective mode, (head, tail) or None for no split); a head and
    tail that cover every step drop the mode."""
    if quantize is None or (fp_head <= 0 and fp_tail <= 0):
        return quantize, None
    if fp_head + fp_tail >= num_steps:
        return None, None  # every step full precision — drop the mode
    return quantize, (max(fp_head, 0), max(fp_tail, 0))


def _precision_segments(q_fn, fp_fn, num_steps: int,
                        split: tuple[int, int]) -> list:
    """The sampler segment list of a split: fp head, quantized middle, fp
    tail (diffusion/samplers._as_segments)."""
    head, tail = split
    return [(head, fp_fn), (num_steps - head - tail, q_fn), (tail, fp_fn)]


def images_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float NCHW → uint8 NHWC on the images' device (diffusers
    numpy_to_pil parity): (x/2 + 0.5) clamped to [0, 1], times 255,
    rounded half to even in fp32."""
    arr = (images.float() / 2 + 0.5).clamp(0.0, 1.0) * 255
    return arr.round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def to_uint8(images: torch.Tensor) -> np.ndarray:
    """`images_uint8` on the host, as numpy."""
    return images_uint8(images).cpu().numpy()


def fetch_uint8(images: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start `to_uint8(images)` and return a function that waits for it.

    On the card the conversion and the copy into pinned host memory are
    queued on the current stream right after the kernels that made
    `images`, and an event after them: the caller can queue the next batch
    at once, and the returned function (callable from any thread) waits for
    this batch's copy alone. On the CPU the array is made at once."""
    u8 = images_uint8(images)
    if u8.device.type != "cuda":
        arr = u8.numpy()
        return lambda: arr
    host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(u8, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def wait() -> np.ndarray:
        copied.synchronize()
        return host.numpy()
    return wait


class PixelDiffusionSampler:
    """DDPMPipeline equivalent over a pixel-space UNet (models/unet2d.py,
    models/simple_unet.py), which carries its weights and device: the
    reference's :102-193. `sampler` is "ddpm" (every train timestep by
    default) or any other of diffusion/samplers.py; `text_embeddings`
    ([1, L, D]) condition every sample; `quantize`, `quant_fp_head` and
    `quant_fp_tail` as StableDiffusionSampler's, w8a8_static calibrated
    once on the unconditioned (or text-conditioned) trajectory and cached
    on disk by weight fingerprint; `sampler_kwargs` go to the sampler.
    A call `sampler(batch_size, seed)` is a BatchSampler: fp32 NCHW images
    in about [-1, 1], the initial noise from a generator seeded `seed`."""

    def __init__(self, model, schedule: DiffusionSchedule, image_size: int,
                 sampler: str = "ddpm", num_steps: int | None = None,
                 text_embeddings: torch.Tensor | None = None,
                 quantize: str | None = None, quant_fp_head: int = 0,
                 quant_fp_tail: int = 0, sampler_kwargs: dict | None = None):
        get_sampler(sampler)  # refuse an unknown sampler before any work
        if quantize not in (None, "w8a8", "w8a8_static"):
            raise ValueError(f"unknown quantization mode: {quantize!r}")
        self.model = model
        self.schedule = schedule
        self.image_size = image_size
        self.sampler = sampler
        self.num_steps = num_steps or schedule.num_train_timesteps
        self.sampler_kwargs = dict(sampler_kwargs or {})
        self.quantize, self._split = _precision_split(
            self.num_steps, quantize, quant_fp_head, quant_fp_tail)
        self.device = next(model.parameters()).device
        self.text_embeddings = (None if text_embeddings is None
                                else text_embeddings.to(self.device))
        self.quant_scales: dict | None = None
        self._scale_bank: quant.ScaleBank | None = None
        if self.quantize == "w8a8_static":
            from polyp_tpu_torch.diffusion.calibrate import ensure_scales
            self.quant_scales = ensure_scales(
                model, schedule,
                (2, model.out_channels, image_size, image_size),
                self.text_embeddings, fingerprint_extras=(
                    image_size, schedule.num_train_timesteps))
            self._scale_bank = quant.ScaleBank(self.quant_scales)

    @torch.no_grad()
    def __call__(self, batch_size: int, seed: int) -> torch.Tensor:
        """`batch_size` images, the initial noise (and a stochastic
        sampler's per-step noise) from a generator seeded `seed`."""
        generator = torch.Generator(self.device).manual_seed(seed)
        emb = self.text_embeddings
        ctx = (None if emb is None
               else emb.expand(batch_size, *emb.shape[-2:]))

        def apply_in(mode):
            def fn(x, t):
                args = (x, t) if ctx is None else (x, t, ctx)
                with quant.override(mode, scales=self._scale_bank, t=t):
                    return self.model(*args)
            return fn

        model_fn = apply_in(self.quantize)
        if self._split is not None:
            model_fn = _precision_segments(model_fn, apply_in(None),
                                           self.num_steps, self._split)
        shape = (batch_size, self.model.out_channels, self.image_size,
                 self.image_size)
        return sample(self.sampler, model_fn, self.schedule, shape,
                      generator, self.num_steps, **self.sampler_kwargs)


class StableDiffusionSampler:
    """StableDiffusionPipeline equivalent over the port's modules (which
    carry their weights and device). The default sampler is UniPC, as the
    reference's (and the scheduler `polyp-lora-per-class` runs); "ddim",
    "dpmpp_2m" and "ddpm" are the others. `quantize` is None,
    "w8a8_static" or "w8a8" (ops/quant.py). `guidance_scale=None` means
    guidance is folded into the UNet (a distilled student);
    `sampler_kwargs` go to the sampler (e.g. the trailing grid);
    `decoder`, a TinyDecoder, replaces the VAE decode and takes the scaled
    latents as they are (reference :295-299); `fused_mha` opts the UNet's
    attentions into the fused MHA kernel."""

    def __init__(self, unet, vae, text_model, tokenizer,
                 schedule: DiffusionSchedule, image_size: int = 256,
                 num_steps: int = 25, guidance_scale: float | None = 7.5,
                 sampler: str = "unipc", quantize: str | None = None,
                 quant_fp_head: int = 0, quant_fp_tail: int = 0,
                 sampler_kwargs: dict | None = None, decoder=None,
                 fused_mha: bool = False):
        get_sampler(sampler)  # refuse an unknown sampler before any work
        if quantize not in (None, "w8a8", "w8a8_static"):
            raise ValueError(f"unknown quantization mode: {quantize!r}")
        self.quantize, self._split = _precision_split(
            num_steps, quantize, quant_fp_head, quant_fp_tail)
        self.quant_scales: dict | None = None
        self._scale_bank: quant.ScaleBank | None = None
        self.unet = unet
        self.vae = vae
        self.text_model = text_model
        self.tokenizer = tokenizer
        self.schedule = schedule
        self.image_size = image_size
        self.num_steps = num_steps
        self.guidance_scale = guidance_scale
        self.sampler = sampler
        self.sampler_kwargs = dict(sampler_kwargs or {})
        self.decoder = decoder
        self.fused_mha = fused_mha
        self.device = next(unet.parameters()).device
        self._encode_cache: dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def encode_prompt(self, prompt: str) -> torch.Tensor:
        if prompt not in self._encode_cache:
            ids = torch.as_tensor(self.tokenizer([prompt]), dtype=torch.long,
                                  device=self.device)
            self._encode_cache[prompt] = self.text_model(ids)
        return self._encode_cache[prompt]

    def register_prompt_embedding(self, prompt: str,
                                  emb: torch.Tensor) -> None:
        """Pin `prompt` to a precomputed [1, 77, D] cond embedding, e.g. a
        distilled student's training-time embedding whose DreamBooth token
        the base text stack cannot encode (reference :260-264)."""
        self._encode_cache[prompt] = torch.as_tensor(emb).to(self.device)

    @torch.no_grad()
    def generate(self, cond: torch.Tensor, uncond: torch.Tensor | None,
                 batch_size: int, generator: torch.Generator | None = None,
                 init: torch.Tensor | None = None) -> torch.Tensor:
        """Sampling + decode. `init` ([B, 4, s/8, s/8] fp32) replaces the
        initial noise drawn from `generator`. Returns fp32 NCHW images in
        about [-1, 1]."""
        return self.decode(self.denoise(cond, uncond, batch_size, generator,
                                        init))

    @torch.no_grad()
    def denoise(self, cond: torch.Tensor, uncond: torch.Tensor | None,
                batch_size: int, generator: torch.Generator | None = None,
                init: torch.Tensor | None = None) -> torch.Tensor:
        """The sampling half of `generate`: fp32 scaled latents."""
        latent = self.image_size // 8
        self._ensure_calibrated(cond, uncond)

        def unet_in(mode):
            def raw(x, t, emb):
                # the UNet alone is quantized and opted into the fused MHA;
                # the decode is not
                with quant.override(mode, scales=self._scale_bank, t=t), \
                        fused_mha_region(self.fused_mha):
                    return self.unet(x, t, emb)
            return with_cfg(raw, cond, uncond, self.guidance_scale)

        model_fn = unet_in(self.quantize)
        if self._split is not None:
            model_fn = _precision_segments(model_fn, unet_in(None),
                                           self.num_steps, self._split)
        return sample(self.sampler, model_fn, self.schedule,
                      (batch_size, 4, latent, latent), generator,
                      self.num_steps, init=init, **self.sampler_kwargs)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents → fp32 images: the tiny decoder takes them as they
        are, the VAE after the 1/0.18215 unscaling."""
        if self.decoder is not None:
            return self.decoder(latents)
        return self.vae.decode(latents / SD_VAE_SCALING)

    def _ensure_calibrated(self, cond: torch.Tensor,
                           uncond: torch.Tensor | None) -> None:
        """w8a8_static's one-time calibration on this stack's own
        trajectory over min(8, num_steps) points (reference :303-324): the
        CFG trajectory, or the folded cond-only one when guidance_scale is
        None (bench.py:216-229). Reused for every prompt and cached on disk
        by weight fingerprint; the guidance mode and the point count are in
        the fingerprint, so a folded sampler never gets the CFG tables of
        the same weights, nor a 4-point one the 8-point tables."""
        if self.quantize != "w8a8_static" or self._scale_bank is not None:
            return
        from polyp_tpu_torch.diffusion.calibrate import ensure_scales
        latent = self.image_size // 8
        points = min(8, self.num_steps)
        folded = self.guidance_scale is None
        self.quant_scales = ensure_scales(
            self.unet, self.schedule, (2, 4, latent, latent), cond[:1],
            None if folded else uncond[:1], num_steps=points,
            guidance_scale=self.guidance_scale,
            fingerprint_extras=(self.image_size,
                                self.schedule.num_train_timesteps,
                                self.guidance_scale,
                                self.schedule.prediction_type, points))
        self._scale_bank = quant.ScaleBank(self.quant_scales)

    def draw_latents(self, sample_ids: Sequence[tuple[int, int]]
                     ) -> tuple[torch.Tensor, torch.Generator]:
        """Each sample's initial latents [4, s/8, s/8] (fp32, on the
        sampler's device) from `request_generator(seed, index)` of its
        (seed, index) pair, stacked [n, 4, s/8, s/8]; and the first pair's
        generator after its draw, the stream of a stochastic sampler's
        per-step noise."""
        latent = self.image_size // 8
        rows, stream = [], None
        for seed, index in sample_ids:
            gen = request_generator(seed, index, self.device)
            rows.append(torch.randn((4, latent, latent), generator=gen,
                                    device=self.device, dtype=torch.float32))
            stream = stream or gen
        return torch.stack(rows), stream

    @torch.no_grad()
    def generate_rows(self, cond: torch.Tensor, latents: torch.Tensor,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        """One launch over rows that each carry their own cond embedding
        (`cond` [n, 77, D]) and initial latents (`latents` [n, 4, s/8,
        s/8]): fp32 NCHW images [n, 3, s, s]. `generator` feeds a
        stochastic sampler's per-step noise (ddpm, ddim with η > 0). The
        convolutions run inside ops.conv.slot_invariant_region, so a row's
        bits do not depend on its slot in the launch."""
        uncond = self.encode_prompt("")
        self._ensure_calibrated(cond, uncond)
        with slot_invariant_region():
            return self.generate(cond, uncond, cond.shape[0], generator,
                                 init=latents)

    @torch.no_grad()
    def generate_batch(self, prompts: Sequence[str],
                       sample_ids: Sequence[tuple[int, int]],
                       pad_to: int | None = None) -> torch.Tensor:
        """One launch for len(prompts) samples, each with its own prompt
        and its own (seed, index) pair (reference :349-405), the
        micro-batching primitive behind serve.py's coalescing. Sample j's
        initial latents come from `request_generator(*sample_ids[j])`.
        Padding to `pad_to` repeats the last row's cond and latents; the
        pad rows are sliced away. Under the deterministic samplers (ddim
        η = 0, dpmpp_2m, unipc) a sample is a function of its own (prompt,
        pair) at a fixed `pad_to`, whatever it is batched with. The
        stochastic ones (ddpm, ddim η > 0) draw one per-step noise for the
        whole launch from the first pair's stream, so the coalescing
        contract excludes them, as in the reference (:357-361). Returns
        fp32 NCHW images in about [-1, 1], len(prompts) rows."""
        n = len(prompts)
        if n == 0:
            raise ValueError("generate_batch needs at least one prompt")
        if len(sample_ids) != n:
            raise ValueError(f"{n} prompts but {len(sample_ids)} sample ids")
        cond = torch.cat([self.encode_prompt(p) for p in prompts])
        latents, stream = self.draw_latents(sample_ids)
        pad = max(pad_to or n, n)
        if pad > n:
            cond = torch.cat([cond, cond[-1:].expand(pad - n,
                                                     *cond.shape[1:])])
            latents = torch.cat([latents, latents[-1:].expand(
                pad - n, *latents.shape[1:])])
        return self.generate_rows(cond, latents, stream)[:n]

    def for_prompt(self, prompt: str) -> BatchSampler:
        cond = self.encode_prompt(prompt)
        uncond = self.encode_prompt("")
        self._ensure_calibrated(cond, uncond)

        def sampler_fn(batch_size: int, seed: int) -> torch.Tensor:
            gen = torch.Generator(self.device).manual_seed(seed)
            return self.generate(cond, uncond, batch_size, gen)

        return sampler_fn


def _write_batch(images: Callable[[], np.ndarray], out_dir: Path,
                 first: int) -> int:
    """Encode and write one fetched batch as `first + 1`, `first + 2`, ...
    .png; returns the number of the last file."""
    arr = images()
    for i, img in enumerate(arr):
        (out_dir / f"{first + i + 1}.png").write_bytes(
            encode_png(img, level=4))
    return first + len(arr)


def generate_to_dir(sampler_fn: BatchSampler, num_images: int,
                    out_dir: str | Path, eval_batch_size: int = 20,
                    seed: int = 0, start_index: int = 0, start_batch: int = 0,
                    progress: Callable[[int, int], None] | None = None) -> int:
    """Quota loop: batch `i` is drawn with seed + i and written as 1-based
    PNG files. Returns images written.

    The reference's one-batch pipeline (:420-443): batch i+1's sampler is
    called before batch i is fetched and encoded. PyTorch's host thread
    issues every kernel of a batch, so batch i is fetched, encoded and
    written by one worker thread (in order) while the host issues batch
    i+1; the native encoder's ctypes call and PIL's zlib release the GIL.
    `progress(done, num_images)` follows each written batch."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    total = 0
    batch_id = start_batch
    pending = None            # the batch sampled last, not yet handed over
    writing: Future | None = None

    def finish(job: Future) -> None:
        done = job.result()
        if progress:
            progress(done - start_index, num_images)

    with ThreadPoolExecutor(max_workers=1) as worker:
        while total < num_images or pending is not None:
            nxt = None
            if total < num_images:
                bs = min(eval_batch_size, num_images - total)
                images = sampler_fn(bs, batch_seed(seed, batch_id))
                nxt = (fetch_uint8(images), start_index + total)
                total += bs
                batch_id += 1
            if pending is not None:
                if writing is not None:
                    finish(writing)
                writing = worker.submit(_write_batch, pending[0], out_dir,
                                        pending[1])
            pending = nxt
        if writing is not None:
            finish(writing)
    return total


def count_samples(out_dir: str | Path) -> int:
    p = Path(out_dir)
    if not p.exists():
        return 0
    return sum(1 for f in p.iterdir() if f.is_file())


def top_up_samples(sampler_fn: BatchSampler, quota: int, out_dir: str | Path,
                   eval_batch_size: int = 20, seed: int = 0,
                   progress: Callable[[int, int], None] | None = None) -> int:
    """Idempotent top-up: generate only the missing tail, resuming the
    deterministic batch sequence. A partial last batch is regenerated in
    full to keep the seed↔image mapping exact."""
    existing = count_samples(out_dir)
    if existing >= quota:
        return 0
    resume_batch = existing // eval_batch_size
    resume_index = resume_batch * eval_batch_size
    return generate_to_dir(sampler_fn, quota - resume_index, out_dir,
                           eval_batch_size, seed, start_index=resume_index,
                           start_batch=resume_batch, progress=progress)
