"""The port's multichip dry run: the twin of polyp_tpu's
`__graft_entry__.dryrun_multichip`, over a group of spawned ranks
(parallel/launch.py) instead of a device mesh.

    python -m polyp_tpu_torch.parallel.dryrun --ranks N [--device cpu]
        [--backend gloo]

The mesh is the reference's: `data=N/2 × model=2` when N ≥ 4 and N is
even (the LoRA steps and the samplers' UNet tensor-parallel over the
model axis, parallel/sharding.py), else `data=N`. It runs the
reference's phases at its tiny shapes (the miniature SD stack, 16 px
images, a global batch of 2 a data rank; on the card the samplers run at
64 px, `sample_size`), each on the mesh:

* two data-parallel LoRA steps (train/sd_finetune.py);
* the CFG UniPC quota fan-out (pipeline.py, `for_prompt`);
* `generate_batch` with `pad_to` (the serving primitive);
* folded-guidance trailing DDIM (the distilled student's sampler);
* the promoted hybrid: w8a8_static with a one-step full-precision head;
* the distilled few-step w8a8_static (folded, trailing DDIM);
* one classifier step (EfficientNet `tiny`, global BatchNorm and loss).

The reference checks only that each phase is finite. Here each phase's
output is also held to the same phase run in one process (`run_phases`
without a mesh) within `TOLERANCES`, and the trained parameters are
checked bit-equal across the ranks. The train steps run there on the
whole global batch. The sampling phases run there as the group launches
them, each data rank's rows a launch (`launched_as_ranks`): the tiny stack's
random UNet is so ill-conditioned that a guided few-step trajectory
turns the ~1e-5 by which a forward's rows move with the batch size into
~0.1 (the full-width model is held to one launch of the whole batch on
the card, chip_smoke.py). On the card (`--device cuda`) ranks that
outnumber the cards share card 0 over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

PROMPT = "a realistic photo of colon polyp"

# max |group − one process| a phase's output may show, fp32 on either
# device (TF32 off): the group's steps are the one-process ones on half the
# rows a rank, and differ by reduction order alone, which the tiny stack's
# random UNet amplifies: one step's LoRA gradients move by 1.3e-4 of their
# largest on the CPU, the second step's (through the first update's
# Adam moves) by 4e-3; the losses by 8e-6. The samples are the same
# launches in another process (the CPU: 0).
TOLERANCES = {
    "lora_loss": 1e-4,        # relative
    "lora_grad": 1e-2,        # of the largest
    "images": 1e-5,           # images in [-1, 1]
    "classifier_loss": 1e-4,  # relative
    "classifier_grad": 1e-3,  # of the largest
}
# on a model axis the forward itself sums in another order (each FF's and
# attention's row-parallel partial products), which the tiny UNet
# amplifies: one process summing its FF down-projection in two halves, as
# two ranks do, moves one step's LoRA gradients by 2.7e-3 of their largest
# (fp32, CPU), and the mesh's two steps by 5e-3-1.8e-2 (CPU) and 1.7e-3
# (card). The sampling phases read, sound against g skipped
# (tools/dryrun_fault.py; images whose largest value is 3-5):
#   fan_out, generate_batch  ≤ 9.4e-3 CPU, ≤ 0.115 card | ≥ 1.18 CPU, ≥ 2.47 card
#   folded                   ≤ 5e-4 CPU, 0.038 card     | 0.83 CPU, 0.42 card
#   promoted_hybrid          0.33-0.45 CPU, 0.13 card   | ≥ 2.85 CPU, 2.50 card
#   distilled_w8a8           8e-3 CPU, 0.044 card       | 0.84 CPU, 0.45 card
# In the int8 ones a rounding tie broken the other way moves a code, which
# cascades towards int8's own distance from full precision
# (test_torch_port_quant.py::ForcedCodes); each limit sits between its
# sound and its fault readings. (Taking a row-parallel layer's int8 scales
# from its own slice, without the model group's max, reads as the sound
# run does here: 0.30 and 0.04 CPU, 0.13 and 0.05 card.)
MODEL_AXIS_TOLERANCES = {**TOLERANCES, "lora_grad": 5e-2, "images": 0.3,
                         "folded": 0.15, "promoted_hybrid": 1.0,
                         "distilled_w8a8": 0.15}


def sample_size(device) -> int:
    """The sampling phases' image size: the reference's 16 px on the CPU;
    64 px on the card, where the int8 conv's product (`torch._int_mm`)
    needs more than 16 rows, which 2×2 latents a rank do not give."""
    return 64 if torch.device(device).type == "cuda" else 16


def _tiny_stack(device, dtype=None):
    """The miniature stack: fp32 on the CPU, as the reference's dry run;
    bf16 on the card, whose GEGLU and attention kernels take bf16 (the
    samplers' stack), unless `dtype` is given."""
    from polyp_tpu_torch.cli.common import load_sd_stack
    if dtype is None:
        dtype = (torch.bfloat16 if torch.device(device).type == "cuda"
                 else torch.float32)
    return load_sd_stack(tiny=True, dtype=dtype, device=device)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float().cpu() for t in tensors])


def mesh_spec(n: int) -> str:
    """The dry run's mesh over n ranks, as the reference picks it."""
    return f"data={n // 2},model=2" if n >= 4 and n % 2 == 0 else \
        f"data={n}"


def run_phases(mesh, device: str, ranks: int,
               model_axis: bool = False) -> dict:
    """Every phase at the global batch of `ranks` data ranks (2 rows a
    rank) on `mesh` (None: all rows in one process); their outputs on the
    CPU, and the checksums of the trained parameters (the whole ones,
    gathered over a model axis). `model_axis`: the run is, or is held
    to, a mesh with a model axis (the LoRA steps then run fp32)."""
    from polyp_tpu_torch.cli.common import replicate_stack
    from polyp_tpu_torch.cli.sd_common import make_components
    from polyp_tpu_torch.configs import ClassificationConfig, DiffusionConfig
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.diffusion.samplers import _gaussian
    from polyp_tpu_torch.lora.surgery import LoRAConfig, init_lora
    from polyp_tpu_torch.parallel import mesh as pmesh
    from polyp_tpu_torch.pipeline import StableDiffusionSampler
    from polyp_tpu_torch.train import classifier as tcls
    from polyp_tpu_torch.train import sd_finetune as tsf
    from polyp_tpu_torch.utils.checkpoint import tree_leaves
    from polyp_tpu_torch.utils.rng import stream_generator

    batch = 2 * ranks
    out: dict = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def local(x):
        return x if mesh is None else mesh.local(x)

    stack = replicate_stack(_tiny_stack(device), mesh)
    # on a model axis the LoRA steps run fp32 on either device (under
    # autograd the UNet takes the plain versions, and the VAE encode's
    # GroupNorm kernel takes fp32): in bf16 the tiny UNet turned the model
    # axis's other summation order into gradients 0.19 of their largest
    # apart on the H100, which would hide the group's arithmetic. A data
    # mesh trains the samplers' stack, bf16 on the card.
    train_stack = (stack if not model_axis
                   or stack.unet.dtype == torch.float32 else
                   replicate_stack(_tiny_stack(device, torch.float32), mesh))
    # two LoRA steps: ≥ 2 optimizer updates, so the updated-trainable path
    # runs, not only the first
    cfg = DiffusionConfig(image_size=16, train_batch_size=batch,
                          num_epochs=1, num_train_timesteps=50,
                          learning_rate=1e-3).with_schedule(2)
    sched = DiffusionSchedule.create(50)
    lcfg = LoRAConfig(rank=2, dropout=0.0)
    trainable = pmesh.replicate_to(tsf.init_trainable(init_lora(
        train_stack.unet, lcfg, stream_generator(0, "lora_init", 0,
                                                 device=device))), mesh)
    frozen = make_components(train_stack, trainable)
    state = tsf.create_sd_train_state(
        cfg, trainable, tsf.trainable_layout(trainable, frozen, mesh), mesh)
    frozen = frozen.on_mesh(mesh)
    ids = torch.zeros((1, 16), dtype=torch.long, device=device)
    losses = []
    for step in range(2):
        images = torch.from_numpy(np.random.default_rng(step).integers(
            0, 256, (batch, 16, 16, 3), dtype=np.uint8)).to(device)
        state, loss = tsf.sd_lora_train_step(
            state, frozen, sched, local(images), ids, None,
            tsf.step_draws(0, 0, step, device), lcfg, mesh=mesh)
        losses.append(float(loss))
    out["lora_loss"] = torch.tensor(losses)
    # Adam's first moment: the steps' gradients, which the group sums in
    # another order (the parameters themselves are held bit-equal across
    # the ranks by checksum: Adam turns a rounding-level gradient into a
    # ±lr move, so parameters are no measure against one process)
    whole = state.tree()
    out["lora_grad"] = _flat(tree_leaves(whole["opt_state"]["mu"]))
    out["lora_checksum"] = pmesh.checksum(whole["trainable"])

    sd_sched = DiffusionSchedule.create(50, "scaled_linear", 0.00085, 0.012)
    size = sample_size(device)

    def sampler(**kw):
        return StableDiffusionSampler(
            stack.unet, stack.vae, stack.text, stack.tokenizer, sd_sched,
            image_size=size, mesh=mesh, **kw)

    def per_prompt(s, seed):
        """for_prompt's batch: the group's, or one process launching the
        ranks' rows of the same latents."""
        if mesh is not None:
            return s.for_prompt(PROMPT)(batch, seed)
        init = _gaussian((batch, 4, size // 8, size // 8),
                         torch.Generator(device).manual_seed(seed), "init")
        return launched_as_ranks(s, s.encode_prompt(PROMPT), init, ranks)

    def per_row(s, prompts, pairs):
        """generate_batch(pad_to=batch), or its rows launched as the
        ranks launch them."""
        if mesh is not None:
            return s.generate_batch(prompts, pairs, pad_to=batch)
        cond = torch.cat([s.encode_prompt(p) for p in prompts])
        return launched_as_ranks(s, cond, s.draw_latents(pairs)[0], ranks,
                                 pad_to=batch)

    trailing = {"spacing": "trailing", "steps_offset": 0}
    cfg_unipc = sampler(num_steps=2, guidance_scale=7.5, sampler="unipc")
    pairs = [(10, 0), (10, 1), (10, 2)]
    out["fan_out"] = per_prompt(cfg_unipc, 9).cpu()
    out["generate_batch"] = per_row(
        cfg_unipc, [PROMPT, "a colon polyp", "polyp"], pairs).cpu()
    out["folded"] = per_row(sampler(
        num_steps=2, guidance_scale=None, sampler="ddim",
        sampler_kwargs=trailing), ["polyp", "polyp"], pairs[:2]).cpu()
    out["promoted_hybrid"] = per_prompt(sampler(
        num_steps=3, guidance_scale=7.5, sampler="ddim",
        quantize="w8a8_static", quant_fp_head=1), 12).cpu()
    out["distilled_w8a8"] = per_row(sampler(
        num_steps=2, guidance_scale=None, sampler="ddim",
        quantize="w8a8_static", sampler_kwargs=trailing),
        ["polyp", "polyp"], pairs[:2]).cpu()

    # one classifier step: BatchNorm statistics and the weighted loss over
    # the global batch
    ccfg = ClassificationConfig(image_size=32, batch_size=batch,
                                hidden_features=8, variant="tiny",
                                mixed_precision="fp32")
    cstate = tcls.create_classifier_state(ccfg, 3, device).on_mesh(mesh)
    rng = np.random.default_rng(11)
    cimgs = torch.from_numpy(rng.integers(0, 256, (batch, 32, 32, 3),
                                          dtype=np.uint8)).to(device)
    clbls = torch.from_numpy(np.arange(batch) % 3).to(device)
    draws = tcls.step_draws(0, 0, 0, cstate.model, batch, device)
    cw = torch.tensor([1.0, 2.0, 0.5], device=device)
    closs, _ = tcls.train_step(cstate, local(cimgs), local(clbls), draws, cw)
    out["classifier_loss"] = torch.tensor([float(closs)])
    out["classifier_grad"] = _flat(cstate.optimizer.state[p]["mu"]
                                   for p in cstate.model.parameters())
    out["classifier_checksum"] = pmesh.checksum(cstate.model)
    for key, value in out.items():
        if isinstance(value, torch.Tensor) and \
                not torch.isfinite(value).all():
            raise AssertionError(f"dry run phase {key} is not finite")
    return out


@torch.no_grad()
def launched_as_ranks(sampler, cond: torch.Tensor, init: torch.Tensor,
                      ranks: int, pad_to: int | None = None
                      ) -> torch.Tensor:
    """One process's images of a batch launched as a group of `ranks`
    launches it (pipeline.py's fan-out): the initial latents `init` (and a
    [n, ...] `cond`) padded to a multiple of the group (and to `pad_to`),
    each rank's rows sampled and decoded in a launch of their own inside
    slot_invariant_region, the rows put back in order."""
    from polyp_tpu_torch.ops.conv import slot_invariant_region
    from polyp_tpu_torch.parallel.mesh import DataMesh, padded_batch
    from polyp_tpu_torch.pipeline import _pad_rows

    n = init.shape[0]
    pad = padded_batch(max(pad_to or n, n), DataMesh(ranks))
    uncond = sampler.encode_prompt("")
    sampler._ensure_calibrated(cond, uncond)
    init = _pad_rows(init, pad)
    if cond.shape[0] > 1:
        cond = _pad_rows(cond, pad)
    per = pad // ranks
    rows = []
    with slot_invariant_region():
        for r in range(ranks):
            part = slice(r * per, (r + 1) * per)
            c = cond[part] if cond.shape[0] > 1 else cond
            rows.append(sampler.decode(sampler.denoise(
                c, uncond, per, None, init[part])).float())
    return torch.cat(rows)[:n]


def _rank(mesh, device: str) -> dict:
    return {**run_phases(mesh, device, mesh.size, mesh.model_size > 1),
            "data_ranks": mesh.size}


def compare(group: dict, single: dict,
            tolerances: dict = TOLERANCES) -> dict:
    """Each phase's max |group − one process| (relative to the largest
    value for the losses and the gradients); raises AssertionError past
    `tolerances`."""
    report = {}
    for key, want in single.items():
        if key.endswith("_checksum"):
            continue
        got = group[key]
        if got.shape != want.shape:
            raise AssertionError(f"{key}: shape {tuple(got.shape)}, one "
                                 f"process {tuple(want.shape)}")
        err = (got - want).abs().max().item()
        if key.endswith(("_loss", "_grad")):
            err /= max(want.abs().max().item(), 1e-12)
        limit = tolerances.get(key, tolerances["images"])
        report[key] = err
        if not err <= limit:
            raise AssertionError(f"dry run phase {key}: {err:.3e} from the "
                                 f"one-process run, limit {limit:.0e}")
    return report


def dryrun_multichip(n: int, device: str = "cpu",
                     backend: str | None = None,
                     timeout: float = 900.0) -> dict:
    """Every phase on `n` spawned ranks (the mesh `mesh_spec(n)`) and in
    this process; returns {"ranks", "mesh", "device", "errors": {phase:
    max |Δ|}, "tolerances"} and raises when a rank fails, a phase leaves
    its tolerance or the ranks' trained parameters differ."""
    from polyp_tpu_torch.parallel.launch import spawn_group
    from polyp_tpu_torch.parallel.mesh import default_backend

    dev = torch.device(device)
    share = dev.type == "cuda" and n > torch.cuda.device_count()
    backend = backend or ("gloo" if share else default_backend(dev))
    if dev.type == "cuda":
        from polyp_tpu_torch import _build
        _build.build()  # the ranks load this library, never race to build
    saved = os.environ.get("POLYP_TORCH_QUANT_CACHE")
    with tempfile.TemporaryDirectory(prefix="polyp-dryrun-") as cache:
        os.environ["POLYP_TORCH_QUANT_CACHE"] = cache
        try:
            ranks = spawn_group(_rank, n, (device,), backend, device,
                                share_device=share, timeout=timeout,
                                spec=mesh_spec(n))
            single = run_phases(None, device, ranks[0]["data_ranks"],
                                "model" in mesh_spec(n))
        finally:
            if saved is None:
                os.environ.pop("POLYP_TORCH_QUANT_CACHE", None)
            else:
                os.environ["POLYP_TORCH_QUANT_CACHE"] = saved
    for key in ("lora_checksum", "classifier_checksum"):
        sums = {r[key] for r in ranks}
        if len(sums) != 1:
            raise AssertionError(f"{key}: the ranks' parameters differ "
                                 f"({len(sums)} checksums)")
    tolerances = (MODEL_AXIS_TOLERANCES if "model" in mesh_spec(n)
                  else TOLERANCES)
    errors = compare(ranks[0], single, tolerances)
    return {"ranks": n, "mesh": mesh_spec(n), "device": device,
            "backend": backend, "errors": errors, "tolerances": tolerances}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--backend", type=str, default=None,
                        help="gloo or nccl (default: nccl with a card a "
                             "rank, else gloo)")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("the dry run runs on the card by default and no "
                         "card is present; pass --device cpu")
    report = dryrun_multichip(args.ranks, args.device, args.backend)
    print(json.dumps(report))
    print("dryrun_multichip OK")
    return report


if __name__ == "__main__":
    main()
