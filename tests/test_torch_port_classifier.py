"""The port's EfficientNet classifier and its trainer against polyp_tpu's on
the CPU: forwards (evaluation and training, with the BatchNorm statistics
a training forward leaves), negative controls, the torchvision importer,
the train step, the epoch loop (early stopping, resume) and the test
metrics.

Both packages run the same weights (the reference's init, its BatchNorm
scales, biases and statistics moved off their init values so no layer is
degenerate, carried by models/importers.py::efficientnet_from_jax) on the
same numpy inputs. The port's stochastic parts take the reference's masks
(`jax_draws`: the flip from fold_in(key, 0); stochastic depth and dropout
recorded from the reference's own forward under fold_in(key, 1)).

Tolerances (relative L2 unless said):
* an evaluation forward: 1e-5 (the same fp32 products in another order);
* a training forward: logits 1e-4, each BatchNorm statistic 1e-5. Batch
  statistics over few values (8 samples at B0's 1×1 final maps at 32 px)
  amplify the reduction order's rounding in the normalised activations;
* the train step (the tiny variant): loss 1e-5 relative; each parameter
  within 1e-2 of the learning rate of the reference's after each update
  (Adam divides by the gradient's RMS, so a relative gradient difference
  ε moves an element by ε·lr); statistics 1e-5. The `project.bn.bias`
  gradients are float noise in both packages: a per-channel shift of a
  projection is removed by the next training-mode BatchNorm through the
  bias-free 1×1 conv that consumes it, so their true gradient is 0 and
  Adam turns the noise into ±lr steps of either sign. They are left out,
  and so, after the second update, are the running means of the
  BatchNorms those shifts reach (every `expand` and the head).
"""

from __future__ import annotations

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from polyp_tpu.configs import ClassificationConfig as JConfig
from polyp_tpu.data import pipeline as jpipe
from polyp_tpu.models.efficientnet import PolypClassifier as JClassifier
from polyp_tpu.models.efficientnet import import_torch_state_dict
from polyp_tpu.train import classifier as jtc
from polyp_tpu.utils.rng import key_for
from polyp_tpu_torch.configs import ClassificationConfig
from polyp_tpu_torch.data import pipeline as tpipe
from polyp_tpu_torch.models import efficientnet as te
from polyp_tpu_torch.models.importers import (
    efficientnet_from_jax, efficientnet_from_torchvision)
from polyp_tpu_torch.train import classifier as tc
from polyp_tpu_torch.train.resume import EpochCheckpointer
from test_torch_efficientnet_golden import fabricate_state_dict
from _torch_threads import THREADS_FOUND, _one_thread  # noqa: F401


@pytest.fixture
def _threads_as_found():
    """The intra-op thread count the process had before _one_thread, for
    one test: the train step's comparison below holds parameters whose
    gradient is near float noise, where Adam's update follows the sign of
    that noise, and the noise follows the order in which the convolution's
    backward sums over threads; with one thread the unweighted case moves
    one such weight 3.4e-5 from the reference's (its tolerance 1e-5), with
    the process's own count it stays inside it."""
    torch.set_num_threads(THREADS_FOUND[-1])
    yield
    torch.set_num_threads(1)


LR = 1e-3
HIDDEN = 16


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def nudge(tree, seed: int):
    """BatchNorm scales 1 + 0.1·N, biases (every bias) 0.1·N, means 0.1·N,
    variances U(0.5, 1.5); kernels as they are."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(move, tree)


def jax_draws(jmodel, variables, shape, key, model) -> tc.ClassifierDraws:
    """The reference's draws of a train step with key `key` for the port's
    `model`: the flip of fold_in(key, 0), and the stochastic-depth and
    dropout masks that the reference's forward draws from fold_in(key, 1),
    recorded in call order (the blocks in order, then the head)."""
    n = shape[0]
    flip = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                           (n,)))
    recorded = []
    bernoulli = jax.random.bernoulli

    def record(*args, **kwargs):
        out = bernoulli(*args, **kwargs)
        recorded.append(np.array(out))
        return out

    with mock.patch.object(jax.random, "bernoulli", record):
        jmodel.apply(variables, jnp.zeros(shape, jnp.float32), train=True,
                     mutable=["batch_stats"],
                     rngs={"dropout": jax.random.fold_in(key, 1)})
    names = [b.block_name for b in model.backbone.blocks() if b.draws_rows]
    assert len(recorded) == len(names) + 1
    return tc.ClassifierDraws(
        torch.from_numpy(flip.copy()),
        {k: torch.from_numpy(r.reshape(-1)) for k, r in zip(names, recorded)},
        torch.from_numpy(recorded[-1]))


@functools.lru_cache(maxsize=None)
def _jax_classifier(variant: str):
    """The reference's classifier and its nudged variables (built once a
    variant; read-only numpy trees)."""
    jm = JClassifier(3, HIDDEN, 0.5, variant)
    v = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 32, 32, 3)))
    return jm, {"params": nudge(v["params"], 2),
                "batch_stats": nudge(v["batch_stats"], 3)}


def _pair(variant: str, size: int, n: int, seed: int = 0):
    """(reference module, its nudged variables, the port's model holding
    them, NHWC fp32 input)."""
    jm, variables = _jax_classifier(variant)
    x = np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)
    model = te.PolypClassifier(3, HIDDEN, 0.5, variant)
    model.load_state_dict(efficientnet_from_jax(variables["params"],
                                                variables["batch_stats"]),
                          strict=True)
    return jm, variables, model, x


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _stats_rel(model, jax_stats) -> float:
    want = efficientnet_from_jax({}, jax.device_get(jax_stats))
    got = model.state_dict()
    return max(rel_l2(got[k], w) for k, w in want.items())


def _forward(variant, size, n, mode, model_patch=None):
    """(logits rel L2, worst statistic rel L2 or None) of one forward of
    the port (optionally changed by `model_patch`) against the
    reference's."""
    jm, variables, model, x = _pair(variant, size, n)
    if model_patch is not None:
        model_patch(model)
    if mode == "eval":
        model.eval()
        with torch.no_grad():
            got = model(_nchw(x))
        return rel_l2(got, jax.jit(jm.apply)(variables, jnp.asarray(x))), None
    key = jax.random.PRNGKey(5)
    draws = jax_draws(jm, variables, x.shape, key, model)
    want, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.fold_in(key, 1)})
    model.train()
    got = model(_nchw(x), draws).detach()
    return rel_l2(got, want), _stats_rel(model, mutated["batch_stats"])


@pytest.mark.parametrize("variant", ["tiny", "b0"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_jax(variant, mode):
    """The tiny variant and B0 at 32 px, batch 8: logits, and after a
    training forward (stochastic depth and dropout on, the reference's
    masks) every BatchNorm's running mean and variance."""
    logits, stats = _forward(variant, 32, 8, mode)
    assert logits <= (1e-5 if mode == "eval" else 1e-4)
    if mode == "train":
        assert stats <= 1e-5


def _same_padding(model):
    """Stride-2 convs padded as SAME: (0, 1) at k = 3, (1, 2) at k = 5."""
    def forward(self, x):
        c = self.conv
        if c.stride[0] == 2:
            k = c.kernel_size[0]
            total = max((-(-x.shape[-1] // 2) - 1) * 2 + k - x.shape[-1], 0)
            x = F.pad(x, (total // 2, total - total // 2) * 2)
            x = F.conv2d(x, c.weight, None, 2, 0, 1, c.groups)
        else:
            x = F.conv2d(x, c.weight, None, c.stride, c.padding, 1, c.groups)
        x = self.bn(x)
        return F.silu(x) if self.act else x

    for m in model.modules():
        if isinstance(m, te.ConvBNAct):
            m.forward = forward.__get__(m)


def _bn_eps(model):
    for m in model.modules():
        if isinstance(m, te.BatchNorm):
            m.eps = 1e-3


def _unbiased_running_var(model):
    def forward(self, x):
        x = x.float()
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=True)
            self.running_mean.mul_(self.decay).add_(mean,
                                                    alpha=1 - self.decay)
            self.running_var.mul_(self.decay).add_(var, alpha=1 - self.decay)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    for m in model.modules():
        if isinstance(m, te.BatchNorm):
            m.forward = forward.__get__(m)


@pytest.mark.parametrize("control,mode,which", [
    (_same_padding, "eval", 0), (_bn_eps, "eval", 0),
    (_unbiased_running_var, "train", 1)])
def test_negative_controls_fail(control, mode, which):
    """Each reference convention broken in turn must break the agreement
    test_forward_matches_jax holds (1e-5) by more than ten times: SAME
    padding at stride 2 and BN eps 1e-3 the evaluation logits, the
    unbiased running variance the statistics (B0, 32 px, batch 8)."""
    assert _forward("b0", 32, 8, mode, control)[which] > 1e-4


def test_se_on_expanded_channels_cannot_take_the_weights():
    """The squeeze-excite width is the block's input channels // 4: a model
    squeezing the expanded channels has other shapes and refuses the
    reference's weights."""
    _, variables, model, _ = _pair("tiny", 32, 2)
    for block in model.backbone.blocks():
        expanded = block.depthwise.conv.in_channels
        block.se = te.SqueezeExcite(expanded, expanded // 4)
    with pytest.raises(RuntimeError, match="size mismatch"):
        model.load_state_dict(efficientnet_from_jax(
            variables["params"], variables["batch_stats"]))


def test_bf16_runs_only_the_stem_conv_in_bf16():
    """Under the "bf16" mixed precision the stem conv runs in bf16 and
    every layer after the stem's BatchNorm in fp32 (the reference's dtype
    flow), and the evaluation logits agree with the reference's bf16 run
    within 1e-2 (the stem's bf16 products summed in another order round
    to another bf16 value now and then)."""
    jm, variables, model, x = _pair("tiny", 32, 4)
    dtypes = {}

    def hook(name):
        def record(module, args, out):
            dtypes.setdefault(name, (args[0].dtype, out.dtype))
        return record

    for name, m in model.named_modules():
        if isinstance(m, (te.ConvBNAct, te.BatchNorm, torch.nn.Linear)):
            m.register_forward_hook(hook(name))
    model.eval()
    with torch.no_grad():
        got = model(_nchw(x).to(torch.bfloat16))
    assert dtypes["backbone.stem"] == (torch.bfloat16, torch.float32)
    assert dtypes["backbone.stem.bn"] == (torch.bfloat16, torch.float32)
    assert model.backbone.stem.conv.weight.dtype == torch.float32
    later = {k: v for k, v in dtypes.items() if not k.startswith(
        "backbone.stem")}
    assert later and all(v == (torch.float32, torch.float32)
                         for v in later.values())
    want = jm.apply(variables, jnp.asarray(x, jnp.bfloat16))
    assert np.asarray(want).dtype == np.float32
    assert rel_l2(got, want) <= 1e-2


def test_torchvision_import_matches_jax():
    """A torchvision-layout B0 state dict (tests/fixtures/manifests) through
    the reference's import_torch_state_dict and the port's importer: every
    backbone tensor bit-equal; an unknown key is refused."""
    sd = fabricate_state_dict(0)
    imported = import_torch_state_dict(_jax_classifier("b0")[1], sd)
    want = efficientnet_from_jax(imported["params"]["backbone"],
                                 imported["batch_stats"]["backbone"])
    got = efficientnet_from_torchvision(
        {k: torch.from_numpy(np.asarray(a)) for k, a in sd.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    te.EfficientNet("b0").load_state_dict(got, strict=True)
    with pytest.raises(KeyError, match="unconsumed"):
        efficientnet_from_torchvision({**sd, "features.9.weight": sd[
            "features.0.0.weight"]})


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    valid = np.array([1, 1, 1, 1, 0, 0], bool)
    cw = np.array([0.5, 2.0, 1.5], np.float32)
    for w in (None, cw):
        for m in (None, valid):
            want = jtc.cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels),
                None if w is None else jnp.asarray(w),
                None if m is None else jnp.asarray(m))
            got = tc.cross_entropy(
                torch.from_numpy(logits), torch.from_numpy(labels),
                None if w is None else torch.from_numpy(w),
                None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_adam_matches_the_optax_chain():
    """make_optimizer (OptaxAdam) against the reference's
    chain(add_decayed_weights(wd), adam(lr)), compiled as the reference's
    train step runs it, over six updates of the same gradients, one
    leaf's gradient 0 (it still decays): equal bit for bit after every
    update (the same fp32 operations in the same order, the bias
    corrections by powf)."""
    import optax

    rng = np.random.default_rng(8)
    shapes = {"a": (5, 3), "b": (4,), "still": (2, 2)}
    params = {k: rng.standard_normal(v).astype(np.float32)
              for k, v in shapes.items()}
    tx = jtc.make_optimizer(JConfig(learning_rate=LR, weight_decay=1e-3))

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    module = torch.nn.ParameterDict(tparams)
    opt = tc.make_optimizer(module, ClassificationConfig(
        learning_rate=LR, weight_decay=1e-3))
    for step in range(6):
        scale = 3.0 if step % 2 else 1e-3
        grads = {k: (scale * rng.standard_normal(v)).astype(np.float32)
                 for k, v in shapes.items()}
        grads["still"][:] = 0.0
        jparams, jstate = update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, jstate, jparams)
        for k, p in module.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_array_equal(module[k].detach().numpy(),
                                          np.asarray(jparams[k]))
    assert not np.allclose(module["still"].detach().numpy(),
                           params["still"])


# ---------------------------------------------------------------------------
# the train step and the epoch loop (the tiny variant, fp32)
# ---------------------------------------------------------------------------

SIZE, BATCH = 32, 8


def _configs(**kw):
    base = dict(image_size=SIZE, batch_size=BATCH, variant="tiny",
                mixed_precision="fp32", hidden_features=HIDDEN,
                learning_rate=LR)
    base.update(kw)
    return JConfig(**base), ClassificationConfig(**base)


def _states(jcfg, cfg, num_classes=3):
    """Both packages' states over the reference's init (nudged)."""
    jstate, jmodel = jtc.create_classifier_state(jcfg, num_classes,
                                                 jax.random.PRNGKey(0))
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, nudge(jstate.params, 2)),
        batch_stats=jax.tree_util.tree_map(
            jnp.asarray, nudge(jstate.batch_stats, 3)))
    state = tc.create_classifier_state(cfg, num_classes, "cpu")
    state.model.load_state_dict(efficientnet_from_jax(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    return jstate, jmodel, state


def _noise(key: str, after_first: bool) -> bool:
    return key.endswith("project.bn.bias") or (after_first and key.endswith(
        ("expand.bn.running_mean", "head.bn.running_mean")))


def assert_state_close(state, jstate, after_first: bool) -> None:
    want = efficientnet_from_jax(jax.device_get(jstate.params),
                                 jax.device_get(jstate.batch_stats))
    got = state.model.state_dict()
    for k, w in want.items():
        if _noise(k, after_first):
            continue
        if "running" in k:
            assert rel_l2(got[k], w) <= 1e-5, k
        else:
            assert (got[k] - w).abs().max() <= 1e-2 * LR, k


@pytest.mark.parametrize("weighted", [False, True])
def test_train_step_matches_jax(weighted, _threads_as_found):
    """Two steps of batch 8 with the reference's draws (flip, stochastic
    depth, dropout), unweighted and class-weighted CE: the loss, every
    parameter and statistic after each update."""
    jcfg, cfg = _configs()
    jstate, jmodel, state = _states(jcfg, cfg)
    rng = np.random.default_rng(1)
    cw = np.array([0.5, 2.0, 1.0], np.float32) if weighted else None
    for step in range(2):
        images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
        labels = rng.integers(0, 3, BATCH).astype(np.int32)
        key = jax.random.PRNGKey(10 + step)
        draws = jax_draws(jmodel, {"params": jstate.params,
                                   "batch_stats": jstate.batch_stats},
                          images.shape, key, state.model)
        jstate, jloss, jcorrect = jtc.train_step(
            jstate, jnp.asarray(images), jnp.asarray(labels), key,
            None if cw is None else jnp.asarray(cw), mp="fp32")
        loss, correct = tc.train_step(
            state, torch.from_numpy(images), torch.from_numpy(labels), draws,
            None if cw is None else torch.from_numpy(cw))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert int(correct) == int(jcorrect)
        assert_state_close(state, jstate, after_first=step > 0)
    assert state.step == 2


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, 3, n).astype(np.int32))


def _jax_step_draws(jmodel, jstate):
    """The port's step_draws, giving the reference's draws of the step key
    key_for(seed, "train", epoch, step)."""
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}

    def draws(seed, epoch, step, model, n, device):
        return jax_draws(jmodel, variables, (n, SIZE, SIZE, 3),
                         key_for(seed, "train", epoch, step), model)

    return draws


def test_train_classifier_two_epochs_matches_jax(monkeypatch):
    """Two epochs over 20 images at batch 8 with weighted sampling
    (drop_last, the reference's index stream) and a validation set of 10
    (a padded tail batch): the train and validation loss histories, the
    best validation accuracy and the best epoch's weights."""
    jcfg, cfg = _configs(num_epochs=2)
    jstate, jmodel, state = _states(jcfg, cfg)
    monkeypatch.setattr(tc, "step_draws", _jax_step_draws(jmodel, jstate))
    (xt, yt), (xv, yv) = _data(20, 1), _data(10, 2)
    w = tpipe.weighted_sample_weights(yt)
    np.testing.assert_array_equal(w, jpipe.weighted_sample_weights(yt))
    jstate, jres = jtc.train_classifier(
        jcfg, jstate, jpipe.Loader(xt, yt, BATCH, seed=0, drop_last=True,
                                   weights=w),
        jpipe.Loader(xv, yv, BATCH, shuffle=False))
    state, res = tc.train_classifier(
        cfg, state, tpipe.Loader(xt, yt, BATCH, seed=0, drop_last=True,
                                 weights=w, device="cpu"),
        tpipe.Loader(xv, yv, BATCH, shuffle=False, device="cpu"))
    np.testing.assert_allclose(res.train_loss_hist, jres.train_loss_hist,
                               rtol=1e-5)
    np.testing.assert_allclose(res.val_loss_hist, jres.val_loss_hist,
                               rtol=1e-5)
    assert res.best_val_acc == jres.best_val_acc
    assert state.step == 4
    best = state.with_params(res.best_params, res.best_batch_stats)
    assert_state_close(best, jstate.replace(params=jres.best_params,
                                            batch_stats=jres.best_batch_stats),
                       after_first=True)


def test_early_stopping_counter_never_resets(monkeypatch):
    """Validation losses 1.0, 2.0 (worse), 0.5 (better), 3.0 (worse) with
    patience 2: the counter is not reset by the improvement, so both
    packages stop after epoch 3 with the epoch-2 weights as the best."""
    jcfg, cfg = _configs(num_epochs=6, patience=2)
    jstate, _, state = _states(jcfg, cfg)
    script = [1.0, 2.0, 0.5, 3.0, 0.1, 0.1]

    def scripted():
        it = iter(script)
        return lambda *a, **k: (next(it), 0.5)

    monkeypatch.setattr(jtc, "_run_validation", scripted())
    monkeypatch.setattr(tc, "_run_validation", scripted())
    xt, yt = _data(8, 3)
    _, jres = jtc.train_classifier(
        jcfg, jstate, jpipe.Loader(xt, yt, BATCH, seed=0, drop_last=True),
        None)
    _, res = tc.train_classifier(
        cfg, state, tpipe.Loader(xt, yt, BATCH, seed=0, drop_last=True,
                                 device="cpu"), None)
    assert res.stopped_epoch == jres.stopped_epoch == 3
    assert res.val_loss_hist == jres.val_loss_hist == script[:4]
    assert state.step == 4


class Crash(Exception):
    pass


def _fresh(cfg):
    return tc.create_classifier_state(cfg, 3, "cpu")


def test_killed_run_resumes_to_the_uninterrupted_result(tmp_path):
    """Three epochs with a snapshot every epoch, killed during epoch 2 and
    run again with the same checkpointer from a fresh state: the weights,
    statistics, optimizer state and histories equal the uninterrupted
    run's bit for bit; a third call of the finished run trains nothing."""
    _, cfg = _configs(num_epochs=3)
    (xt, yt), (xv, yv) = _data(16, 4), _data(8, 5)

    def loaders():
        return (tpipe.Loader(xt, yt, BATCH, seed=0, drop_last=True,
                             device="cpu"),
                tpipe.Loader(xv, yv, BATCH, shuffle=False, device="cpu"))

    whole, whole_res = tc.train_classifier(cfg, _fresh(cfg), *loaders())

    step = tc.train_step
    calls = []

    def crash_in_epoch_2(state, *args):  # two steps an epoch
        calls.append(1)
        if len(calls) == 5:
            raise Crash
        return step(state, *args)

    ckpt = EpochCheckpointer(tmp_path / "ckpt", every=1)
    with mock.patch.object(tc, "train_step", crash_in_epoch_2):
        with pytest.raises(Crash):
            tc.train_classifier(cfg, _fresh(cfg), *loaders(),
                                checkpointer=ckpt)
    assert ckpt.latest_epoch() == 1
    resumed, res = tc.train_classifier(cfg, _fresh(cfg), *loaders(),
                                       checkpointer=ckpt)
    assert res.train_loss_hist == whole_res.train_loss_hist
    assert res.val_loss_hist == whole_res.val_loss_hist
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for k, v in whole_res.best_params.items():
        assert torch.equal(res.best_params[k], v), k
    assert resumed.step == whole.step == 6
    again, res3 = tc.train_classifier(cfg, _fresh(cfg), *loaders(),
                                      checkpointer=ckpt)
    assert again.step == 6 and res3.stopped_epoch is None
    for k, v in whole.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_evaluate_classifier_matches_jax():
    """The test metrics of the same weights over 11 images at batch 8 (a
    padded tail masked out): accuracy, weighted precision / recall / F1,
    the confusion matrix and the report."""
    jcfg, cfg = _configs()
    jstate, _, state = _states(jcfg, cfg)
    x, y = _data(11, 6)
    idx2label = {0: "AD", 1: "ASS", 2: "HP"}
    want = jtc.evaluate_classifier(
        jstate, jpipe.Loader(x, y, BATCH, shuffle=False), idx2label, "fp32")
    got = tc.evaluate_classifier(
        state, tpipe.Loader(x, y, BATCH, shuffle=False, device="cpu"),
        idx2label)
    for k in ("accuracy", "precision", "recall", "f1_score", "report",
              "labels"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  want["confusion_matrix"])


def test_create_classifier_state_defaults_to_the_card():
    """With no device the classifier is built on the card, and without a
    card it raises rather than move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.create_classifier_state(ClassificationConfig(variant="tiny"), 3)


def test_classification_config_is_the_references():
    """Every field and default of the reference's ClassificationConfig
    (the timestamped output directory aside)."""
    def fields(config):
        out = dataclasses.asdict(config)
        assert out.pop("output_dir").startswith("runs/classifier_")
        return out

    assert fields(ClassificationConfig()) == fields(JConfig())
