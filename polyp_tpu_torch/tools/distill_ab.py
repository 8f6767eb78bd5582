"""A/B harness: progressive distillation on a TRAINED tiny DDPM, the twin
of the repo-root tools/distill_ab.py on the H100.

On a model trained by gradient descent (not an exact-capacity student),
does the distilled few-step student reproduce the teacher's many-step
trajectory better than the teacher's OWN few-step grid, and how do the two
student heads (v_prediction vs epsilon) compare under a fixed, small
training budget?

Protocol:
  1. train a tiny_scratch_unet ε-DDPM on synthetic soft-blob images
     (random centre + colour in [-1, 1], the polyp-corpus stand-in);
  2. reference = the teacher's 16-step trailing DDIM from fixed noise;
  3. baseline = the teacher's own 4-step trailing DDIM, same noise;
  4. distill 16 → 4 with each student head, same data and budget
     (train/distill.py::distill_progressive);
  5. report each 4-step run's rel RMSE against the 16-step reference.

`--sd` runs the same protocol on the SD shape of the problem: the tiny
conditional UNet (cross-attention, 4-channel latents,
models/unet_condition.py::tiny_condition_unet) trained with CFG-style
conditioning dropout on a fabricated textured-lesion latent corpus
(class-dependent spatial frequency + eccentric soft masks, structured
enough that the guided trajectory curves), then distilled 16 → 4 WITH
guidance folding (the teacher runs CFG at 2× batch, the student is
cond-only at 1×) under the shipped defaults (`epsilon` head, auto-scaled
reparam). The claim under test: the default settings beat the teacher's
own 4-step grid on its 16-step CFG reference. In both modes a v-student
whose ε→v warmup the convergence guard refuses
(train/distill.py::check_reparam_converged) is a reported row
("REFUSED"), as the reference's --sd mode reports it; the reference's
unconditional mode predates the guard and would end there instead.

The data, the weights (the reference's init scheme) and the sampling
noise come from seeds (numpy and seeded torch generators); JAX's
threefry draws other numbers, so the rows agree with the reference's in
what they show, not digit for digit.

Usage:
  python -m polyp_tpu_torch.tools.distill_ab [--train_steps 600]
      [--steps_per_phase 200] [--reparam_steps N] [--learning_rate 1e-3]
  python -m polyp_tpu_torch.tools.distill_ab --sd
  ... --device cpu   (the card unless given the CPU)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.func import functional_call

from polyp_tpu_torch.cli.common import init_weights_
from polyp_tpu_torch.diffusion.samplers import ddim_sample, with_cfg
from polyp_tpu_torch.diffusion.schedule import DiffusionSchedule
from polyp_tpu_torch.models.unet2d import tiny_scratch_unet
from polyp_tpu_torch.models.unet_condition import tiny_condition_unet
from polyp_tpu_torch.train.classifier import OptaxAdam
from polyp_tpu_torch.train.distill import (ReparamGuardError,
                                           distill_progressive)

T, SIZE = 512, 16
BATCH, CORPUS = 16, 256


def make_data(n: int, seed: int) -> torch.Tensor:
    """Soft blobs [n, 3, SIZE, SIZE]: a random centre in the interior, a
    random RGB colour, background −1."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(4.0, 12.0, (n, 1, 1, 1))
    cy = rng.uniform(4.0, 12.0, (n, 1, 1, 1))
    col = rng.uniform(-1.0, 1.0, (n, 3, 1, 1))
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    d2 = (xx[None, None] - cx) ** 2 + (yy[None, None] - cy) ** 2
    blob = np.exp(-d2 / 8.0)
    return torch.from_numpy((blob * col - (1 - blob)).astype(np.float32))


def make_latent_corpus(n: int, seed: int, size: int = 8) -> torch.Tensor:
    """Fabricated textured-lesion latents [n, 4, size, size] (the SD-mode
    corpus): an eccentric soft mask times a banded texture whose spatial
    frequency is the class signal, plus a structured background, at the
    [-1, 1]-ish scale of VAE latents. The high-frequency content makes the
    guided DDIM trajectory curve, so few-step grids lose accuracy."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(2.0, size - 2, (n, 1, 1, 1))
    cy = rng.uniform(2.0, size - 2, (n, 1, 1, 1))
    ecc = rng.uniform(0.5, 2.0, (n, 1, 1, 1))
    freq = rng.uniform(1.5, 3.5, (n, 1, 1, 1))
    phase = rng.uniform(0.0, 2 * np.pi, (n, 1, 1, 1))
    amp = rng.uniform(0.5, 1.0, (n, 4, 1, 1))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    xx, yy = xx[None, None], yy[None, None]
    d2 = ecc * (xx - cx) ** 2 + (yy - cy) ** 2 / ecc
    mask = np.exp(-d2 / 6.0)
    tex = np.sin(freq * xx + phase) * np.cos(freq * yy - phase)
    bg = 0.3 * np.sin(0.7 * xx) * np.sin(0.9 * yy)
    return torch.from_numpy(
        (amp * (mask * tex + (1 - mask) * bg)).astype(np.float32))


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("distill_ab runs on the CUDA card by default and "
                           "no card is present; pass --device cpu")
    return device


def _schedule(prediction_type: str = "epsilon") -> DiffusionSchedule:
    return DiffusionSchedule.create(T, "scaled_linear", 0.00085, 0.012,
                                    prediction_type=prediction_type)


def _seeded(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def _train_teacher(model: torch.nn.Module, data: torch.Tensor,
                   steps: int, ctx_fn=None) -> float:
    """`steps` ε-MSE Adam(2e-3) steps over `data` in batches of 16, each
    step's draws from the generator seeded 100 + step: t, ε and, with
    `ctx_fn(n, generator)`, the step's conditioning. The final loss."""
    sched = _schedule().to(data.device)
    opt = OptaxAdam(model.parameters(), lr=2e-3)
    model.train()
    loss = torch.zeros(())
    for i in range(steps):
        x0 = data[(i * BATCH) % CORPUS:(i * BATCH) % CORPUS + BATCH]
        gen = _seeded(data.device, 100 + i)
        n = x0.shape[0]
        t = torch.randint(0, T, (n,), generator=gen, device=data.device)
        noise = torch.randn(x0.shape, generator=gen, device=data.device)
        x_t = sched.add_noise(x0, noise, t)
        args = (x_t, t) if ctx_fn is None else (x_t, t, ctx_fn(n, gen))
        loss = torch.mean(torch.square(model(*args) - noise))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    model.eval()
    return loss.item()


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a - ref) ** 2))
                 / torch.sqrt(torch.mean(ref ** 2)))


def _sample(fn, sched: DiffusionSchedule, init: torch.Tensor,
            steps: int) -> torch.Tensor:
    return ddim_sample(fn, sched, tuple(init.shape), None, steps, init=init,
                       spacing="trailing", steps_offset=0)


def _phase_losses(result) -> list[tuple[int, float]]:
    return [(ph.num_steps, round(float(np.mean(ph.losses[-10:])), 5))
            for ph in result.phases]


def run_sd_mode(args) -> dict:
    """SD-shaped conditional A/B with guidance folding (module
    docstring); returns the rows' rel RMSEs (None for a refused head)."""
    device = _device(args.device)
    t0 = time.time()
    size, ctx_dim, gs = 8, 32, 4.0
    model = tiny_condition_unet(device=device)
    init_weights_(model, _seeded(device, 0))
    data = make_latent_corpus(CORPUS, 3, size).to(device)
    cond = torch.randn((1, 16, ctx_dim), generator=_seeded(device, 4),
                       device=device) * 0.4
    uncond = torch.zeros((1, 16, ctx_dim), device=device)

    def ctx(n, gen):
        # CFG-style conditioning dropout: 20% of samples see the uncond
        # embedding, so the guided teacher has a real uncond branch
        drop = torch.rand((n, 1, 1), generator=gen, device=device) < 0.2
        return torch.where(drop, uncond.expand(n, -1, -1),
                           cond.expand(n, -1, -1))

    loss = _train_teacher(model, data, args.train_steps, ctx)
    print(f"conditional teacher trained: final loss {loss:.4f} "
          f"({time.time() - t0:.0f}s)", flush=True)

    sched = _schedule()
    teacher = {k: p.detach().clone() for k, p in model.named_parameters()}
    init = torch.randn((16, 4, size, size), generator=_seeded(device, 77),
                       device=device)
    guided = with_cfg(lambda x, t, e: model(x, t, e), cond, uncond, gs)
    with torch.no_grad():
        ref16 = _sample(guided, sched, init, 16)
        raw4 = _sample(guided, sched, init, 4)
    rows = {"teacher_4step": _rel(raw4, ref16)}
    print(f"teacher-4step  vs teacher-16step rel RMSE: "
          f"{rows['teacher_4step']:.4f} (CFG {gs}, 2x batch)", flush=True)

    def batches():
        return [data[i:i + BATCH] for i in range(0, CORPUS, BATCH)]

    for head in ("epsilon", "v_prediction"):
        label = head + (" (SHIPPED DEFAULTS)" if head == "epsilon" else "")
        try:
            result = distill_progressive(
                model, teacher, sched, batches, start_steps=16, end_steps=4,
                steps_per_phase=args.steps_per_phase,
                learning_rate=args.learning_rate, weight_decay=0.0,
                student_prediction_type=head, reparam_steps=-1,
                guidance_scale=gs, cond=cond, uncond=uncond)
        except ReparamGuardError as e:  # a reported result
            rows[head] = None
            print(f"{label:34s}: REFUSED by the convergence guard: "
                  f"{str(e)[:120]}", flush=True)
            continue

        def student_fn(x, t, _p=result.params):
            return functional_call(model, _p, (x, t, cond.expand(
                x.shape[0], -1, -1)))

        with torch.no_grad():
            got4 = _sample(student_fn, _schedule(head), init, 4)
        rows[head] = _rel(got4, ref16)
        print(f"{label:34s}-4step (folded, 1x batch) vs teacher-16step "
              f"rel RMSE: {rows[head]:.4f}  (phase losses "
              f"{_phase_losses(result)})", flush=True)
    print(f"total {time.time() - t0:.0f}s", flush=True)
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train_steps", type=int, default=600)
    p.add_argument("--steps_per_phase", type=int, default=200)
    p.add_argument("--reparam_steps", type=int, default=None,
                   help="default: steps_per_phase // 2")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--sd", action="store_true",
                   help="SD-shaped conditional A/B with guidance folding "
                        "(module docstring)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless given the CPU")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Run the A/B; prints the rows and returns their rel RMSEs
    ({"teacher_4step", "epsilon", "v_prediction"}, None for a refused
    head)."""
    args = build_parser().parse_args(argv)
    if args.sd:
        return run_sd_mode(args)
    device = _device(args.device)
    reparam = (args.steps_per_phase // 2 if args.reparam_steps is None
               else args.reparam_steps)
    t0 = time.time()
    model = tiny_scratch_unet(device=device)
    init_weights_(model, _seeded(device, 0))
    data = make_data(CORPUS, 3).to(device)
    loss = _train_teacher(model, data, args.train_steps)
    print(f"teacher trained: final loss {loss:.4f} "
          f"({time.time() - t0:.0f}s)", flush=True)

    sched = _schedule()
    teacher = {k: p.detach().clone() for k, p in model.named_parameters()}
    init = torch.randn((16, 3, SIZE, SIZE), generator=_seeded(device, 77),
                       device=device)
    with torch.no_grad():
        ref16 = _sample(lambda x, t: model(x, t), sched, init, 16)
        raw4 = _sample(lambda x, t: model(x, t), sched, init, 4)
    rows = {"teacher_4step": _rel(raw4, ref16)}
    print(f"teacher-4step  vs teacher-16step rel RMSE: "
          f"{rows['teacher_4step']:.4f}", flush=True)

    def batches():
        return [data[i:i + BATCH] for i in range(0, CORPUS, BATCH)]

    for head in ("epsilon", "v_prediction"):
        try:
            result = distill_progressive(
                model, teacher, sched, batches, start_steps=16,
                end_steps=4, steps_per_phase=args.steps_per_phase,
                learning_rate=args.learning_rate, weight_decay=0.0,
                student_prediction_type=head, reparam_steps=reparam)
        except ReparamGuardError as e:  # a reported result
            rows[head] = None
            print(f"{head:13s}: REFUSED by the convergence guard: "
                  f"{str(e)[:120]}", flush=True)
            continue

        def student_fn(x, t, _p=result.params):
            return functional_call(model, _p, (x, t))

        with torch.no_grad():
            got4 = _sample(student_fn, _schedule(head), init, 4)
        rows[head] = _rel(got4, ref16)
        print(f"{head:13s}-4step vs teacher-16step rel RMSE: "
              f"{rows[head]:.4f}  (phase losses {_phase_losses(result)})",
              flush=True)
    print(f"total {time.time() - t0:.0f}s", flush=True)
    return rows


if __name__ == "__main__":
    main()
