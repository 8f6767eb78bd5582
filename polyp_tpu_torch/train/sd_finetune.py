"""Stable-Diffusion LoRA fine-tuning (LoRA, text-encoder LoRA, DreamBooth
rows, visual influence, unfrozen base layers, gradient accumulation): the
twin of polyp_tpu/train/sd_finetune.py.

The frozen stack (VAE, CLIP, UNet modules) is never written. The
trainable bundle is a dict of fp32 tensors
  {"unet_lora", "text_lora"?, "proj"?, "special_rows"?, "unfrozen"?}
and one step does: augmentation (flip) → frozen VAE encode under
`torch.no_grad()` (its GroupNorms take the GroupNorm kernel on the card)
→ posterior sample × 0.18215 → noise and timesteps → text encoding (under
`no_grad` unless the text LoRA or DreamBooth rows train) → the LoRA-merged
UNet through `torch.func.functional_call` (the flash kernel at the level-0
self-attentions, with its plain backward; GEGLU and GroupNorm take their
plain versions under autograd, as the reference's differentiated step does)
→ ε-MSE (+ the visual-influence cosine loss) → gradients of the bundle only
→ `SDOptimizer`: optax's chain(clip_by_global_norm(1.0), adamw(cosine
warmup, weight_decay=1e-2)) inside MultiSteps(accumulation_steps).

Precision: the stack may be bf16, where bf16(W) + δ would round a young
adapter's δ away. The targeted kernels' fp32 weights (SDComponents
`unet_params` / `text_params`, from SDStack.fp32_params) take the merge,
which rounds once to the module's dtype (lora/surgery.py).

Random draws: JAX's threefry cannot be reproduced in torch, so every draw
of a step (flip mask, posterior noise, ε, timesteps, one [in, 1] dropout
keep mask a targeted kernel) goes through one `StepDraws` object from
`step_draws(seed, epoch, step, device)`, a generator seeded by the stream
(seed, "sd_lora", epoch, step) (utils/rng.py). Tests hand the step a
`StepDraws` that returns the reference's draws.

The loss is the intended w_img·mse + w_text·cos, as in the reference (its
docstring: weight_img=2.0 reproduces the original script's double count).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch
import torch.utils.checkpoint
from torch import nn
from torch.func import functional_call

from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.data.pipeline import Loader
from polyp_tpu_torch.data.transforms import augment_diffusion_batch
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.diffusion.losses import (
    epsilon_mse_loss, visual_influence_loss)
from polyp_tpu_torch.lora.surgery import LoRAConfig, merge_lora
from polyp_tpu_torch.models.vae import SD_VAE_SCALING, DiagonalGaussian
from polyp_tpu_torch.train.dreambooth import embed_with_special_rows
from polyp_tpu_torch.train.scratch_ddpm import cosine_warmup_schedule
from polyp_tpu_torch.utils.checkpoint import tree_leaves, tree_map
from polyp_tpu_torch.utils.faults import maybe_crash
from polyp_tpu_torch.utils.rng import stream_generator

TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"


@dataclass(frozen=True)
class SDComponents:
    """The frozen modules, and the base parameters the trainable bundle is
    merged into: `unet_params` / `text_params` hold the fp32 weights of
    every kernel an adapter targets ("{module}.weight"), and
    `text_params` a grown token table (DreamBooth) where there is one.
    `remat` reruns the UNet forward in the backward
    (torch.utils.checkpoint), trading operations for activation memory."""

    unet: nn.Module
    vae: nn.Module
    text: nn.Module
    unet_params: dict[str, torch.Tensor]
    text_params: dict[str, torch.Tensor] = field(default_factory=dict)
    remat: bool = False

    def with_remat(self) -> "SDComponents":
        return replace(self, remat=True)

    def unet_apply(self, params: dict[str, torch.Tensor], x: torch.Tensor,
                   t: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        def run(x, t, ctx):
            return functional_call(self.unet, params, (x, t, ctx))

        if self.remat:
            return torch.utils.checkpoint.checkpoint(run, x, t, ctx,
                                                     use_reentrant=False)
        return run(x, t, ctx)

    def text_apply(self, params: dict[str, torch.Tensor],
                   ids: torch.Tensor) -> torch.Tensor:
        return functional_call(self.text, params, (ids,))


class StepDraws:
    """Every random draw of one train step, in this order from one
    generator: the flip mask, the posterior noise, ε, the timesteps, then
    the dropout keep masks (UNet adapter, then text adapter, each in
    adapter order)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def flip(self, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self.generator,
                          device=self.generator.device) < 0.5

    def normal(self, what: str, shape) -> torch.Tensor:
        """A standard normal fp32 draw; `what` is "posterior" or "noise"."""
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device)

    def timesteps(self, n: int, high: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=self.generator,
                             device=self.generator.device)

    def keep_mask(self, stream: str, name: str, rows: int,
                  keep: float) -> torch.Tensor:
        """The fp32 [rows, 1] keep mask of adapter `stream` ("unet" or
        "text") at module `name`."""
        return (torch.rand(rows, 1, generator=self.generator,
                           device=self.generator.device) < keep).float()


def step_draws(seed: int, epoch: int, step: int,
               device: torch.device | str) -> StepDraws:
    """The draws of step `step` of epoch `epoch`: a pure function of the
    three, so a resumed run draws what an uninterrupted one would."""
    return StepDraws(stream_generator(seed, "sd_lora", epoch, step,
                                      device=device))


def _zip_tree(tree: Any, values) -> Any:
    """`tree` with its leaves replaced by `values` in `tree_leaves`
    order."""
    values = iter(values)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(values)

    return walk(tree)


class SDOptimizer:
    """optax.chain(clip_by_global_norm(1.0), adamw(schedule,
    weight_decay=1e-2)), inside optax.MultiSteps(accumulation_steps) when
    that is above 1, on nested dicts of fp32 tensors, updated in place.

    As optax: clipping scales by MAX_NORM / ‖g‖ when ‖g‖ ≥ MAX_NORM, with
    no ε; the schedule is read at the update count before it advances (so
    the first update of a warmup schedule moves nothing); weight decay
    applies to every leaf; under accumulation the mean of k micro-step
    gradients (a running mean) takes one update on the k-th micro-step,
    and the schedule counts updates, not micro-steps."""

    MAX_NORM = 1.0
    B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults
    WEIGHT_DECAY = 1e-2

    def __init__(self, schedule: Callable[[int], float],
                 accumulation_steps: int = 1):
        self.schedule = schedule
        self.k = max(int(accumulation_steps), 1)

    def init(self, params: dict) -> dict:
        state = {"count": 0, "mu": tree_map(torch.zeros_like, params),
                 "nu": tree_map(torch.zeros_like, params)}
        if self.k > 1:
            state.update(mini_step=0,
                         acc=tree_map(torch.zeros_like, params))
        return state

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> bool:
        """Apply one (micro-)step of `grads` to `params` and `state` in
        place; True when the parameters moved (every k-th micro-step).
        Multi-tensor (`torch._foreach_*`) operations over all leaves, each
        the elementwise operation optax applies, in its order."""
        g = tree_leaves(grads)
        if self.k > 1:
            acc = tree_leaves(state["acc"])
            n = state["mini_step"]
            step = torch._foreach_sub(g, acc)
            torch._foreach_div_(step, n + 1)
            torch._foreach_add_(acc, step)
            if n + 1 < self.k:
                state["mini_step"] = n + 1
                return False
            state["mini_step"] = 0
            g = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        p = tree_leaves(params)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        f32 = dict(dtype=torch.float32, device=p[0].device)
        norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
        clipped = norm >= self.MAX_NORM  # then g / ‖g‖ · MAX_NORM
        g = torch._foreach_div(g, torch.where(clipped, norm, 1.0))
        torch._foreach_mul_(g, torch.where(clipped, self.MAX_NORM, 1.0))
        count = state["count"] + 1
        # powf of a float exponent, as XLA computes decay ** count
        t = torch.tensor(float(count), **f32)
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, gg)
        u = torch._foreach_div(mu, 1 - torch.tensor(b1, **f32) ** t)
        v = torch._foreach_div(nu, 1 - torch.tensor(b2, **f32) ** t)
        torch._foreach_sqrt_(v)
        torch._foreach_add_(v, self.EPS)
        torch._foreach_div_(u, v)
        torch._foreach_add_(u, torch._foreach_mul(p, self.WEIGHT_DECAY))
        torch._foreach_mul_(u, -torch.tensor(
            self.schedule(state["count"]), **f32))
        torch._foreach_add_(p, u)
        state["count"] = count
        return True


def make_sd_optimizer(config: DiffusionConfig) -> SDOptimizer:
    sched = cosine_warmup_schedule(config.learning_rate,
                                   config.lr_warmup_steps,
                                   config.total_train_steps)
    return SDOptimizer(sched, config.accumulation_steps)


def init_trainable(unet_lora: dict, text_lora: dict | None = None,
                   proj: dict | None = None,
                   special_rows: torch.Tensor | None = None,
                   unfrozen: dict | None = None) -> dict:
    out = {"unet_lora": unet_lora}
    if text_lora is not None:
        out["text_lora"] = text_lora
    if proj is not None:
        out["proj"] = proj
    if special_rows is not None:
        out["special_rows"] = special_rows
    if unfrozen is not None:
        out["unfrozen"] = unfrozen
    return out


def init_proj_params(generator: torch.Generator, latent_channels: int = 4,
                     text_width: int = 768) -> dict:
    """The visual-influence projection Linear(4 → 768): kernel [in, out]
    N(0, 1) / √in, bias 0."""
    k = torch.randn(latent_channels, text_width, generator=generator,
                    device=generator.device)
    return {"kernel": k / latent_channels ** 0.5,
            "bias": torch.zeros(text_width, device=generator.device)}


@dataclass
class SDTrainState:
    step: int
    trainable: dict
    opt_state: dict
    tx: SDOptimizer

    def tree(self) -> dict:
        """What a checkpoint holds."""
        return {"step": self.step, "trainable": self.trainable,
                "opt_state": self.opt_state}

    @torch.no_grad()
    def restore(self, tree: dict) -> None:
        """Take a checkpoint's values in place (the trainables stay the
        tensors that require grad)."""
        for p, v in zip(tree_leaves(self.trainable),
                        tree_leaves(tree["trainable"])):
            p.copy_(v)
        self.step = int(tree["step"])
        self.opt_state = tree["opt_state"]


def create_sd_train_state(config: DiffusionConfig,
                          trainable: dict) -> SDTrainState:
    """The state over fp32 copies of `trainable` (never views of what the
    caller holds, so nothing of the stack can be trained in place)."""
    own = tree_map(lambda t: t.detach().float().clone().requires_grad_(),
                   trainable)
    tx = make_sd_optimizer(config)
    return SDTrainState(0, own, tx.init(tree_map(torch.detach, own)), tx)


def _keep_masks(draws: StepDraws, stream: str, adapter: dict,
                cfg: LoRAConfig) -> dict | None:
    if cfg.dropout <= 0.0:
        return None
    keep = 1.0 - cfg.dropout
    return {name: draws.keep_mask(stream, name, f["lora_A"].shape[0], keep)
            for name, f in adapter.items()}


def module_dtype(module: nn.Module) -> torch.dtype:
    """The dtype of a module's weights (its first matrix or kernel)."""
    return next(p.dtype for n, p in module.named_parameters()
                if n.endswith(".weight") and p.ndim > 1)


def sd_lora_loss_and_grads(
        state: SDTrainState, frozen: SDComponents,
        schedule: DiffusionSchedule, images_u8: torch.Tensor,
        prompt_ids: torch.Tensor, special_ids: torch.Tensor | None,
        draws: StepDraws, unet_lora_cfg: LoRAConfig,
        text_lora_cfg: LoRAConfig | None = None, weight_img: float = 1.0,
        weight_text: float = 0.1) -> tuple[torch.Tensor, dict]:
    """The step's loss (fp32 scalar) and its gradients with respect to
    every trainable (a tree shaped as `state.trainable`)."""
    trainable = state.trainable
    n = images_u8.shape[0]
    x0 = augment_diffusion_batch(images_u8, draws.flip(n))
    with torch.no_grad():  # the frozen VAE: no gradient flows here
        posterior = DiagonalGaussian(frozen.vae.encode_moments(x0))
    latents = posterior.sample(
        draws.normal("posterior", posterior.mean.shape)) * SD_VAE_SCALING
    noise = draws.normal("noise", latents.shape)
    timesteps = draws.timesteps(n, schedule.num_train_timesteps)
    noisy = schedule.add_noise(latents, noise, timesteps)
    ids = prompt_ids.to(images_u8.device).expand(n, prompt_ids.shape[-1])
    unet_masks = _keep_masks(draws, "unet", trainable["unet_lora"],
                             unet_lora_cfg)
    text_masks = (_keep_masks(draws, "text", trainable["text_lora"],
                              text_lora_cfg)
                  if "text_lora" in trainable else None)

    with torch.enable_grad():
        text_params = {k: v for k, v in frozen.text_params.items()
                       if k == TOKEN_TABLE}
        if "special_rows" in trainable:
            table = frozen.text_params.get(
                TOKEN_TABLE, frozen.text.get_parameter(TOKEN_TABLE))
            text_params[TOKEN_TABLE] = embed_with_special_rows(
                table, trainable["special_rows"], special_ids)
        if "text_lora" in trainable:
            text_params.update(merge_lora(
                frozen.text_params, trainable["text_lora"], text_lora_cfg,
                text_masks, module_dtype(frozen.text)))
        if "text_lora" in trainable or "special_rows" in trainable:
            hidden = frozen.text_apply(text_params, ids)
        else:
            with torch.no_grad():
                hidden = frozen.text_apply(text_params, ids)

        dtype = module_dtype(frozen.unet)
        kernels = frozen.unet_params
        unet_params = {}
        if "unfrozen" in trainable:
            # selected base weights train beside the adapter
            kernels = {**kernels, **trainable["unfrozen"]}
            unet_params = {k: v.to(frozen.unet.get_parameter(k).dtype)
                           for k, v in trainable["unfrozen"].items()}
        unet_params.update(merge_lora(kernels, trainable["unet_lora"],
                                      unet_lora_cfg, unet_masks, dtype))
        pred = frozen.unet_apply(unet_params, noisy, timesteps, hidden)
        loss = epsilon_mse_loss(schedule, pred, latents, noise, timesteps)
        if "proj" in trainable:
            aux = visual_influence_loss(hidden, latents,
                                        trainable["proj"]["kernel"],
                                        trainable["proj"]["bias"])
            loss = weight_img * loss + weight_text * aux
        leaves = tree_leaves(trainable)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _zip_tree(trainable, grads)


def sd_lora_train_step(
        state: SDTrainState, frozen: SDComponents,
        schedule: DiffusionSchedule, images_u8: torch.Tensor,
        prompt_ids: torch.Tensor, special_ids: torch.Tensor | None,
        draws: StepDraws, unet_lora_cfg: LoRAConfig,
        text_lora_cfg: LoRAConfig | None = None, weight_img: float = 1.0,
        weight_text: float = 0.1) -> tuple[SDTrainState, torch.Tensor]:
    """One (micro-)step: gradients of the bundle, then the optimizer,
    in place on `state` (returned, with the step's loss)."""
    loss, grads = sd_lora_loss_and_grads(
        state, frozen, schedule, images_u8, prompt_ids, special_ids, draws,
        unet_lora_cfg, text_lora_cfg, weight_img, weight_text)
    state.tx.update(grads, state.opt_state, state.trainable)
    state.step += 1
    return state, loss


@dataclass
class SDTrainResult:
    loss_hist: list[float] = field(default_factory=list)


def train_sd_lora(
        config: DiffusionConfig, state: SDTrainState, frozen: SDComponents,
        schedule: DiffusionSchedule, loader: Loader, prompt_ids,
        unet_lora_cfg: LoRAConfig, text_lora_cfg: LoRAConfig | None = None,
        special_ids=None, log: Callable[[str, float, int], None] | None = None,
        epoch_callback: Callable[[int, SDTrainState], None] | None = None,
        checkpointer=None, start_epoch: int = 0,
        step_callback: Callable[[int, int, SDTrainState, torch.Tensor],
                                None] | None = None,
) -> tuple[SDTrainState, SDTrainResult]:
    """The epoch loop. With an `EpochCheckpointer` (train/resume.py) that
    holds a snapshot, training restores it, fast-forwards the loader
    (`Loader.skip_epochs`) and goes on with the batches and draws of an
    uninterrupted run (a step's draws are a function of (seed, epoch,
    step)). `step_callback(epoch, step, state, loss)` runs after each
    step; `epoch_callback(epoch, state)` after each epoch and its
    snapshot."""
    result = SDTrainResult()
    if checkpointer is not None and start_epoch == 0:
        restored = checkpointer.restore(state.tree())
        if restored is not None:
            tree, start_epoch = restored
            state.restore(tree)
            aux = checkpointer.restore_aux() or {}
            result.loss_hist = list(aux.get("loss_hist", []))
            loader.skip_epochs(start_epoch)
    device = loader.device
    ids = torch.as_tensor(prompt_ids, device=device)
    sids = (torch.as_tensor(special_ids, dtype=torch.long, device=device)
            if special_ids is not None else None)
    for epoch in range(start_epoch, config.num_epochs):
        losses = []
        for step, (images, _, _) in enumerate(loader):
            state, loss = sd_lora_train_step(
                state, frozen, schedule, images, ids, sids,
                step_draws(config.seed, epoch, step, device), unet_lora_cfg,
                text_lora_cfg, config.weight_img, config.weight_text)
            losses.append(loss)
            if step_callback:
                step_callback(epoch, step, state, loss)
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
