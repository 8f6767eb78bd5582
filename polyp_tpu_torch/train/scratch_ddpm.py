"""Per-class pixel-space DDPM training, the scratch path: the twin of
polyp_tpu/train/scratch_ddpm.py.

One step does: augmentation (flip) → ε and timesteps → q-sample → the
UNet's ε̂ → ε-MSE → gradients → the optimizer, which is optax's chain
(clip_by_global_norm(1.0), adamw(cosine warmup, weight_decay=1e-2)) in
MultiSteps(accumulation_steps): the LoRA trainer's `SDOptimizer`
(train/sd_finetune.py), on the UNet's whole parameter dict.

Precision, as the reference's flax `dtype`: the state keeps fp32 master
parameters, which the optimizer updates; each step casts them to the
module's parameter dtypes (bf16 for `polyp_scratch_unet`, fp32 for its
norms and `conv_out`) inside the autograd graph and runs the module on
them through `torch.func.functional_call`, so the gradients reach the
fp32 masters. The module's own parameters are never read by a step; the
sampler loads the masters into it (`DDPMState.load_into_model`), which
rounds them once to the module's dtype. Under autograd GroupNorm and the
attentions run their plain versions (the scratch UNet's attentions have
196 or 49 tokens at 224 px, below flash's 1,024).

Random draws: one `StepDraws` a step (train/sd_finetune.py) from the
generator seeded by the stream (seed, "ddpm", epoch, step) (utils/rng.py):
the flip mask, ε, the timesteps, in the roles of the reference's
`split(key, 3)`, so a resumed run draws what an uninterrupted one would
and a test can hand the step the reference's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.data.pipeline import Loader
from polyp_tpu_torch.data.transforms import augment_diffusion_batch
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.diffusion.losses import epsilon_mse_loss
from polyp_tpu_torch.utils.faults import maybe_crash
from polyp_tpu_torch.utils.rng import stream_generator


def cosine_warmup_schedule(learning_rate: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, learning_rate,
    max(warmup_steps, 1), max(total_steps, 2), 0): linear from 0 over the
    warmup (so update 0 has learning rate 0), then cosine decay to 0 over
    the rest; `total_steps` counts the warmup. Maps an update count to its
    learning rate."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, 2) - warmup
    if decay <= 0:
        raise ValueError(f"total_steps {total_steps} leaves no decay after "
                         f"{warmup} warmup steps")

    def schedule(count: int) -> float:
        if count < warmup:
            return learning_rate * (1.0 - (1.0 - min(max(count, 0), warmup)
                                           / warmup))
        t = min(count - warmup, decay)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def ddpm_draws(seed: int, epoch: int, step: int,
               device: torch.device | str):
    """The draws of step `step` of epoch `epoch`: a pure function of the
    three."""
    from polyp_tpu_torch.train.sd_finetune import StepDraws
    return StepDraws(stream_generator(seed, "ddpm", epoch, step,
                                      device=device))


@dataclass
class DDPMState:
    """The train state: `params`, the fp32 masters of every parameter of
    `model` (by its state-dict names); the optimizer and its state."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: dict
    tx: object
    model: nn.Module

    def tree(self) -> dict:
        """What a checkpoint holds."""
        return {"step": self.step, "params": self.params,
                "opt_state": self.opt_state}

    @torch.no_grad()
    def restore(self, tree: dict) -> None:
        """Take a checkpoint's values in place (the masters stay the
        tensors that require grad)."""
        for name, p in self.params.items():
            p.copy_(tree["params"][name])
        self.step = int(tree["step"])
        self.opt_state = tree["opt_state"]

    @torch.no_grad()
    def load_into_model(self) -> nn.Module:
        """The model with the masters copied in (each rounded once to its
        parameter's dtype), for sampling; returns the model."""
        for name, p in self.model.named_parameters():
            p.copy_(self.params[name])
        return self.model


def create_ddpm_state(config: DiffusionConfig, model: nn.Module,
                      generator: torch.Generator) -> DDPMState:
    """fp32 masters drawn by the reference's init scheme (flax's defaults:
    lecun-normal kernels, zero biases, unit norm scales;
    cli/common.py::_init_values) from `generator`, on its device, and
    copied into `model`."""
    from polyp_tpu_torch.cli.common import _init_values
    from polyp_tpu_torch.train.sd_finetune import make_sd_optimizer

    params = {}
    with torch.no_grad():
        for name, p, value in _init_values(model, generator):
            if isinstance(value, float):
                value = torch.full(p.shape, value, device=generator.device)
            params[name] = value.float().requires_grad_()
            p.copy_(value)
    # the reference's chain (scratch_ddpm.py:52-62) is the LoRA trainer's
    tx = make_sd_optimizer(config)
    return DDPMState(0, params, tx.init({k: v.detach()
                                         for k, v in params.items()}),
                     tx, model)


def ddpm_loss_and_grads(state: DDPMState, schedule: DiffusionSchedule,
                        images_u8: torch.Tensor, draws,
                        text_embeddings: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, dict]:
    """The step's ε-MSE (fp32 scalar) and its gradients with respect to
    every master parameter."""
    n = images_u8.shape[0]
    x0 = augment_diffusion_batch(images_u8, draws.flip(n))
    noise = draws.normal("noise", x0.shape)
    timesteps = draws.timesteps(n, schedule.num_train_timesteps)
    noisy = schedule.add_noise(x0, noise, timesteps)
    dtypes = {k: p.dtype for k, p in state.model.named_parameters()}
    args = (noisy, timesteps)
    if text_embeddings is not None:
        args += (text_embeddings.expand(n, *text_embeddings.shape[-2:]),)
    with torch.enable_grad():
        weights = {k: v.to(dtypes[k]) for k, v in state.params.items()}
        pred = functional_call(state.model, weights, args)
        loss = epsilon_mse_loss(schedule, pred, x0, noise, timesteps)
        leaves = list(state.params.values())
        # a conditioned model run without a context leaves its
        # cross-attentions out: their gradients are 0, as the reference's
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(state.params.items(), grads)}


def ddpm_train_step(state: DDPMState, schedule: DiffusionSchedule,
                    images_u8: torch.Tensor, draws,
                    text_embeddings: torch.Tensor | None = None
                    ) -> tuple[DDPMState, torch.Tensor]:
    """One (micro-)step: augment → q-sample → ε̂ → MSE → clipped update,
    in place on `state` (returned, with the step's loss)."""
    loss, grads = ddpm_loss_and_grads(state, schedule, images_u8, draws,
                                      text_embeddings)
    state.tx.update(grads, state.opt_state, state.params)
    state.step += 1
    return state, loss


@dataclass
class DDPMTrainResult:
    loss_hist: list[float] = field(default_factory=list)


def train_scratch_ddpm(
        config: DiffusionConfig, state: DDPMState,
        schedule: DiffusionSchedule, loader: Loader,
        text_embeddings: torch.Tensor | None = None,
        log: Callable[[str, float, int], None] | None = None,
        epoch_callback: Callable[[int, DDPMState], None] | None = None,
        checkpointer=None, start_epoch: int = 0,
) -> tuple[DDPMState, DDPMTrainResult]:
    """The epoch loop (the reference's :117-157). With an
    `EpochCheckpointer` (train/resume.py) that holds a snapshot, training
    restores it, fast-forwards the loader (`Loader.skip_epochs`) and goes
    on with the batches and draws of an uninterrupted run;
    `maybe_crash("epoch", n)` follows each snapshot (utils/faults.py).
    `epoch_callback(epoch, state)` runs after each epoch and its snapshot
    (the CLI's final-epoch sample-and-save hook)."""
    result = DDPMTrainResult()
    if checkpointer is not None and start_epoch == 0:
        restored = checkpointer.restore(state.tree())
        if restored is not None:
            tree, start_epoch = restored
            state.restore(tree)
            aux = checkpointer.restore_aux() or {}
            result.loss_hist = list(aux.get("loss_hist", []))
            loader.skip_epochs(start_epoch)
    device = loader.device
    if text_embeddings is not None:
        text_embeddings = text_embeddings.to(device)
    for epoch in range(start_epoch, config.num_epochs):
        losses = []
        for step, (images, _, _) in enumerate(loader):
            state, loss = ddpm_train_step(
                state, schedule, images,
                ddpm_draws(config.seed, epoch, step, device),
                text_embeddings)
            losses.append(loss)  # device scalars: one sync an epoch
        avg = torch.stack(losses).mean().item()
        result.loss_hist.append(avg)
        if log:
            log("train_loss", avg, epoch)
        if checkpointer is not None and checkpointer.save(
                epoch, state.tree(), aux={"loss_hist": result.loss_hist}):
            maybe_crash("epoch", epoch)  # a no-op unless a test arms it
        if epoch_callback:
            epoch_callback(epoch, state)
    return state, result

