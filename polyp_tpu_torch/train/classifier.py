"""Classifier training: the twin of polyp_tpu/train/classifier.py, as a
module, an optimizer and plain functions (no compilation).

* `make_optimizer`: `OptaxAdam`, the reference's optax
  chain(add_decayed_weights(wd), adam(lr)) as a torch optimizer: the decay
  is added to the gradient before the moments, and every operation is
  optax's, in its order and in fp32, with the bias corrections 1 − β^t
  raised by powf as XLA computes them in the reference's compiled step
  (torch's Adam computes them in double and divides in another order).
* `cross_entropy`: the mean NLL weighted by class weights and the `valid`
  mask, normalised by the summed weights (torch CrossEntropyLoss's
  weighted mean).
* `train_step` / `eval_step`: one batch. Mixed precision "bf16" feeds the
  network bf16 images, so its stem conv runs in bf16 and everything after
  the stem's BatchNorm in fp32 (models/efficientnet.py).
* `train_classifier`: the epoch loop with early stopping on the
  validation loss. The early-stop counter counts epochs without
  improvement and is never reset by an improvement (the reference's
  contract). The best epoch's parameters and BatchNorm statistics are kept
  on the host. With an `EpochCheckpointer` (train/resume.py), a killed run
  restarted with the same checkpointer resumes from the last snapshot
  (`Loader.skip_epochs`) and gives the batches and updates of an
  uninterrupted run; a run that finished returns at once.
* `evaluate_classifier`: weighted precision / recall / F1, accuracy, the
  confusion matrix and the report on the test set (eval/metrics.py).

Random draws: the reference draws the flip from fold_in(key, 0) and the
stochastic depth and dropout from fold_in(key, 1) of the step key. torch
cannot reproduce threefry, so every draw of a step comes from one
`ClassifierDraws` (`step_draws(seed, epoch, step, model, n, device)`: a
generator seeded by the stream (seed, "train", epoch, step),
utils/rng.py); the tests hand the step the reference's masks instead.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from polyp_tpu_torch.configs import ClassificationConfig
from polyp_tpu_torch.data.pipeline import Loader
from polyp_tpu_torch.data.transforms import augment_classifier_batch
from polyp_tpu_torch.eval import metrics as M
from polyp_tpu_torch.models.efficientnet import (
    PolypClassifier, init_classifier_)
from polyp_tpu_torch.utils.faults import maybe_crash
from polyp_tpu_torch.utils.rng import stream_generator

MIXED_PRECISION = {"bf16": torch.bfloat16, "fp32": torch.float32}


@dataclass
class ClassifierDraws:
    """Every random draw of one train step: the flip mask [n], one keep
    row [n] for each block with stochastic depth (by block name), and the
    head's dropout keep mask [n, hidden] (None without dropout)."""

    flip: torch.Tensor
    drop_path: dict[str, torch.Tensor]
    dropout: torch.Tensor | None


def draw_step(model: PolypClassifier, n: int,
              generator: torch.Generator) -> ClassifierDraws:
    """A step's draws from `generator`, in this order: the flip mask, the
    stochastic-depth rows in block order, the dropout mask."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device)

    flip = uniform(n) < 0.5
    rows = {b.block_name: uniform(n) < 1.0 - b.drop_path
            for b in model.backbone.blocks() if b.draws_rows}
    dropout = (uniform(n, model.fc1.out_features) < 1.0 - model.dropout
               if model.dropout > 0.0 else None)
    return ClassifierDraws(flip, rows, dropout)


def step_draws(seed: int, epoch: int, step: int, model: PolypClassifier,
               n: int, device) -> ClassifierDraws:
    """The draws of step `step` of epoch `epoch`: a pure function of the
    three, so a resumed run draws what an uninterrupted one would."""
    return draw_step(model, n, stream_generator(seed, "train", epoch, step,
                                                device=device))


@dataclass
class ClassifierState:
    """The classifier, its optimizer and the input dtype its mixed
    precision gives."""

    model: PolypClassifier
    optimizer: torch.optim.Optimizer
    dtype: torch.dtype
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def tree(self) -> dict:
        """What a checkpoint holds."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def restore(self, tree: dict) -> None:
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.step = int(tree["step"])

    def host_params(self) -> tuple[dict, dict]:
        """CPU copies of the parameters and of the BatchNorm statistics."""
        params = {k: v.detach().cpu().clone()
                  for k, v in self.model.named_parameters()}
        stats = {k: v.detach().cpu().clone()
                 for k, v in self.model.named_buffers()}
        return params, stats

    def with_params(self, params: dict, batch_stats: dict
                    ) -> "ClassifierState":
        """A state over a copy of the model holding `params` and
        `batch_stats` (the best epoch's, say); this state is unchanged."""
        model = copy.deepcopy(self.model)
        model.load_state_dict({**params, **batch_stats})
        # the constructor's own arguments: a restored optimizer's
        # `defaults` also hold torch's (load_state_dict adds
        # `differentiable`), which OptaxAdam does not take
        optimizer = OptaxAdam(model.parameters(), **{
            k: self.optimizer.defaults[k]
            for k in ("lr", "weight_decay", "betas", "eps")})
        return ClassifierState(model, optimizer, self.dtype, self.step)


class OptaxAdam(torch.optim.Optimizer):
    """optax.chain(add_decayed_weights(weight_decay), adam(lr, b1, b2,
    eps)) over the parameters that have a gradient, updated in place by
    multi-tensor operations, each the elementwise operation of the
    reference's compiled step, in its order: g + wd·p; μ = (1 − β1)·g +
    β1·μ; ν = (1 − β2)·g² + β2·ν; p − lr·μ / ((1 − β1^t)·(√(ν / (1 −
    β2^t)) + ε)) (XLA folds optax's μ / (1 − β1^t) / (…) into one
    division). β^t is fp32 powf of the update count, as XLA raises it.
    `lr` is a rate, or a schedule of the update count (read before the
    count advances, as optax's scale_by_schedule reads it)."""

    def __init__(self, params, lr: float | Callable[[int], float],
                 weight_decay: float = 0.0,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      betas=tuple(betas), eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            p = [q for q in group["params"] if q.grad is not None]
            if not p:
                continue
            for q in p:
                if not self.state[q]:
                    self.state[q].update(count=0,
                                         mu=torch.zeros_like(q),
                                         nu=torch.zeros_like(q))
            states = [self.state[q] for q in p]
            mu, nu = [s["mu"] for s in states], [s["nu"] for s in states]
            b1, b2 = group["betas"]
            g = [q.grad for q in p]
            # each `alpha` form is one fused multiply-add, where XLA
            # contracts the reference's product and sum, with the same
            # operand in the product: wd·p, (1 − β1)·g, β2·ν and −lr·u
            if group["weight_decay"]:
                g = torch._foreach_add(g, p, alpha=group["weight_decay"])
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            gg = torch._foreach_mul(g, g)
            torch._foreach_mul_(gg, 1 - b2)
            torch._foreach_add_(gg, nu, alpha=b2)
            torch._foreach_copy_(nu, gg)
            count = states[0]["count"] + 1
            f32 = dict(dtype=torch.float32, device=p[0].device)
            t = torch.tensor(float(count), **f32)
            v = torch._foreach_div(nu, 1 - torch.tensor(b2, **f32) ** t)
            torch._foreach_sqrt_(v)
            torch._foreach_add_(v, group["eps"])
            torch._foreach_mul_(v, 1 - torch.tensor(b1, **f32) ** t)
            lr = group["lr"]
            torch._foreach_add_(p, torch._foreach_div(mu, v), alpha=-(
                lr(count - 1) if callable(lr) else lr))
            for s in states:
                s["count"] = count


def make_optimizer(model: torch.nn.Module, config: ClassificationConfig
                   ) -> OptaxAdam:
    return OptaxAdam(model.parameters(), lr=config.learning_rate,
                     weight_decay=config.weight_decay)


def create_classifier_state(config: ClassificationConfig, num_classes: int,
                            device: torch.device | str = "cuda",
                            generator: torch.Generator | None = None
                            ) -> ClassifierState:
    """A new PolypClassifier of `config.variant` on `device`, initialised
    from `generator` (default: seeded `config.seed` on `device`), with its
    Adam. Built on the card unless the caller passes a CPU device; with no
    card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the classifier trains on the CUDA card by default and no card "
            "is present; pass device='cpu' to train on the CPU")
    if config.mixed_precision not in MIXED_PRECISION:
        raise ValueError(f"unknown mixed precision "
                         f"{config.mixed_precision!r}")
    model = PolypClassifier(num_classes, config.hidden_features,
                            config.dropout, config.variant, device=device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(config.seed)
    init_classifier_(model, generator)
    return ClassifierState(model, make_optimizer(model, config),
                           MIXED_PRECISION[config.mixed_precision])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: torch.Tensor | None = None,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean NLL with optional per-class weights and a `valid` row mask,
    normalised by the sum of the rows' weights."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    w = (torch.ones_like(nll) if class_weights is None
         else class_weights.to(nll.device)[labels.long()])
    if valid is not None:
        w = w * valid.to(w.dtype)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)


def train_step(state: ClassifierState, images_u8: torch.Tensor,
               labels: torch.Tensor, draws: ClassifierDraws,
               class_weights: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One update on a batch; returns (loss, correct count) as device
    scalars."""
    model = state.model
    model.train()
    x = augment_classifier_batch(images_u8, draws.flip, state.dtype)
    logits = model(x, draws)
    loss = cross_entropy(logits, labels, class_weights)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    correct = (logits.detach().argmax(-1) == labels.long()).sum()
    return loss.detach(), correct


@torch.no_grad()
def eval_step(state: ClassifierState, images_u8: torch.Tensor,
              labels: torch.Tensor, valid: torch.Tensor,
              class_weights: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss over the valid rows, predictions, correct valid rows)."""
    state.model.eval()
    x = augment_classifier_batch(images_u8, None, state.dtype)
    logits = state.model(x)
    loss = cross_entropy(logits, labels, class_weights, valid)
    preds = logits.argmax(-1)
    correct = ((preds == labels.long()) & valid).sum()
    return loss, preds, correct


@dataclass
class TrainResult:
    train_loss_hist: list[float] = field(default_factory=list)
    val_loss_hist: list[float] = field(default_factory=list)
    best_val_acc: float = 0.0
    best_params: dict | None = None
    best_batch_stats: dict | None = None
    stopped_epoch: int | None = None


def _run_validation(state: ClassifierState, loader: Loader,
                    class_weights) -> tuple[float, float]:
    losses, correct, total = [], 0, 0
    for images, labels, valid in loader:
        loss, _, c = eval_step(state, images, labels, valid, class_weights)
        losses.append(loss.item())
        correct += int(c)
        total += int(valid.sum())
    return float(np.mean(losses)), correct / max(total, 1)


def train_classifier(
        config: ClassificationConfig, state: ClassifierState,
        train_loader: Loader, val_loader: Loader,
        class_weights: np.ndarray | None = None,
        log: Callable[[str, float, int], None] | None = None,
        checkpointer=None) -> tuple[ClassifierState, TrainResult]:
    """The epoch loop with early stopping; returns the final state and the
    history with the best (lowest validation loss) epoch's parameters."""
    device = state.device
    cw = (torch.as_tensor(class_weights, dtype=torch.float32, device=device)
          if class_weights is not None else None)
    result = TrainResult()
    best_val_loss = float("inf")
    early_stopping = 0
    start_epoch = 0

    if checkpointer is not None:
        restored = checkpointer.restore(None)
        if restored is not None:
            tree, start_epoch = restored
            aux = checkpointer.restore_aux() or {}
            state.restore(tree["state"])
            result.best_params = tree["best_params"]
            result.best_batch_stats = tree["best_batch_stats"]
            result.best_val_acc = aux.get("best_val_acc", 0.0)
            result.train_loss_hist = list(aux.get("train_loss_hist", []))
            result.val_loss_hist = list(aux.get("val_loss_hist", []))
            best_val_loss = aux.get("best_val_loss", float("inf"))
            early_stopping = aux.get("early_stopping", 0)
            if aux.get("finished") and (
                    aux.get("stopped_epoch") is not None
                    or start_epoch >= config.num_epochs):
                # a finished (or early-stopped) run called again with the
                # same budget trains nothing; a larger num_epochs goes on
                result.stopped_epoch = aux.get("stopped_epoch")
                return state, result
            train_loader.skip_epochs(start_epoch)

    def aux(finished: bool = False) -> dict:
        return {"best_val_loss": best_val_loss,
                "early_stopping": early_stopping,
                "best_val_acc": result.best_val_acc,
                "train_loss_hist": result.train_loss_hist,
                "val_loss_hist": result.val_loss_hist,
                "stopped_epoch": result.stopped_epoch,
                "finished": finished}

    def snapshot() -> dict:
        return {"state": state.tree(), "best_params": result.best_params,
                "best_batch_stats": result.best_batch_stats}

    epoch = start_epoch
    for epoch in range(start_epoch, config.num_epochs):
        losses = []
        for step, (images, labels, _) in enumerate(train_loader):
            draws = step_draws(config.seed, epoch, step, state.model,
                               images.shape[0], device)
            loss, _ = train_step(state, images, labels, draws, cw)
            losses.append(loss)  # device scalars: one sync an epoch
        train_loss = torch.stack(losses).mean().item()
        result.train_loss_hist.append(train_loss)

        val_loss, val_acc = _run_validation(state, val_loader, cw)
        result.val_loss_hist.append(val_loss)
        if log:
            log("train_loss", train_loss, epoch)
            log("val_loss", val_loss, epoch)
            log("val_accuracy", val_acc, epoch)

        if val_loss < best_val_loss:
            best_val_loss = val_loss
            result.best_val_acc = val_acc
            result.best_params, result.best_batch_stats = state.host_params()
        else:
            early_stopping += 1  # never reset: the reference's contract

        if early_stopping == config.patience:
            result.stopped_epoch = epoch
            break
        if checkpointer is not None and checkpointer.save(
                epoch, snapshot(), aux=aux()):
            maybe_crash("epoch", epoch)  # a no-op unless a test arms it

    if checkpointer is not None and config.num_epochs > start_epoch:
        # the terminal snapshot: a rerun of a finished job returns at once
        checkpointer.save(epoch, snapshot(), aux=aux(finished=True),
                          force=True)
    return state, result


def evaluate_classifier(state: ClassifierState, test_loader: Loader,
                        idx2label: dict[int, str]) -> dict[str, Any]:
    """Test metrics over the valid rows, with labels decoded to strings:
    accuracy, weighted precision / recall / F1, the confusion matrix and
    the per-class report, over the sorted true labels."""
    all_preds, all_true = [], []
    for images, labels, valid in test_loader:
        _, preds, _ = eval_step(state, images, labels, valid)
        mask = valid.cpu().numpy()
        all_preds.extend(preds.cpu().numpy()[mask].tolist())
        all_true.extend(labels.cpu().numpy()[mask].tolist())
    pred_labels = [idx2label[i] for i in all_preds]
    true_labels = [idx2label[i] for i in all_true]
    order = sorted(set(true_labels))
    precision, recall, f1 = M.precision_recall_f1(true_labels, pred_labels,
                                                  "weighted", order)
    return {
        "accuracy": M.accuracy_score(true_labels, pred_labels),
        "precision": precision,
        "recall": recall,
        "f1_score": f1,
        "confusion_matrix": M.confusion_matrix(true_labels, pred_labels,
                                               order),
        "report": M.classification_report(true_labels, pred_labels, order),
        "labels": order,
    }
