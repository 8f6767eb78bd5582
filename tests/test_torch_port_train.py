"""The LoRA train step of polyp_tpu_torch against polyp_tpu's on the CPU:
the optimizer against the optax chain, and `sd_lora_train_step` for each
flag set (the epoch loop, resume and the frozen stack's weights are in
tests/test_torch_port_train_loop.py, which shares `_setup` and
`JaxDraws`).

Both packages start from the same weights (the reference's tiny stack with
seeded weights, carried by models/importers.py) and the same
trainable bundle (`trainable_from_jax`); the port's step takes the
reference's random draws (`JaxDraws`: the flip mask, posterior noise, ε,
timesteps and the dropout keep masks that polyp_tpu derives from the step's
key), so the two steps compute the same function. Everything runs in fp32.

Tolerances: losses 1e-5 relative; gradients 1e-4 of the largest gradient
of their bundle entry (the same products summed in another order, through
the tiny UNet, VAE and CLIP); one Adam update 1e-2 of the learning rate
(Adam divides each gradient by its own RMS, so a relative gradient
difference ε moves an element by ε·lr). A wrong mask, transpose, merge,
clip or schedule gives O(1) of these.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyp_tpu.configs import DiffusionConfig as JConfig
from polyp_tpu.diffusion import DiffusionSchedule as JSchedule
from polyp_tpu.lora import partition as jpart
from polyp_tpu.lora import surgery as jsurg
from polyp_tpu.models.clip_text import CLIPTextModel as JCLIP
from polyp_tpu.train import dreambooth as jdb
from polyp_tpu.train import sd_finetune as jsf
from polyp_tpu_torch.cli.sd_common import make_components
from polyp_tpu_torch.configs import LORA_MODULE_PRESETS, DiffusionConfig
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.lora import surgery as tsurg
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.train import sd_finetune as tsf
from polyp_tpu_torch.utils.checkpoint import tree_leaves
from test_torch_port_lora import (
    jax_keep_mask, jax_tiny_stack, port_tiny_stack)
from _torch_threads import _one_thread  # noqa: F401


SD = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
          beta_start=0.00085, beta_end=0.012)
LR = 1e-3
L = 16  # the tiny CLIP's context
TEXT_TARGETS = LORA_MODULE_PRESETS["text_encoder"]


class JaxDraws(tsf.StepDraws):
    """The port's step draws, made as polyp_tpu's step makes them from
    `key`: split into (flip, posterior, noise, timesteps, dropout) keys;
    NHWC draws handed over as NCHW."""

    def __init__(self, key):
        self.keys = jax.random.split(key, 5)

    def flip(self, n):
        return torch.from_numpy(np.array(
            jax.random.bernoulli(self.keys[0], 0.5, (n,))))

    def normal(self, what, shape):
        n, c, h, w = shape
        key = self.keys[1] if what == "posterior" else self.keys[2]
        a = np.array(jax.random.normal(key, (n, h, w, c), jnp.float32))
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())

    def timesteps(self, n, high):
        return torch.from_numpy(np.array(
            jax.random.randint(self.keys[3], (n,), 0, high), np.int64))

    def keep_mask(self, stream, name, rows, keep):
        rng = jax.random.fold_in(self.keys[4], 0 if stream == "unet" else 1)
        return torch.from_numpy(jax_keep_mask(rng, name, rows, keep))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accumulation", [1, 2])
def test_optimizer_matches_the_optax_chain(accumulation):
    """k micro-steps of the same gradients through optax's
    chain(clip_by_global_norm(1), adamw(warmup cosine, 1e-2)) in
    MultiSteps and through SDOptimizer: update 0 moves nothing (lr 0),
    gradient norms above and below 1 (the clip), a leaf whose gradient is
    0 still decays; 1e-6 relative per step (the same fp32 formulas)."""
    rng = np.random.default_rng(50)
    shapes = {"a": {"lora_A": (6, 2), "lora_B": (2, 5)}, "rows": (1, 4),
              "still": (3,)}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    cfg = JConfig(learning_rate=0.1, num_epochs=1,
                  accumulation_steps=accumulation).with_schedule(
                      5 * accumulation)
    tx = jsf.make_sd_optimizer(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    topt = tsf.make_sd_optimizer(DiffusionConfig(
        learning_rate=0.1, num_epochs=1,
        accumulation_steps=accumulation).with_schedule(5 * accumulation))
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                     params)
    tstate = topt.init(tparams)
    moved = []
    for i in range(5 * accumulation):
        scale = 3.0 if i % 3 == 0 else 0.05  # norms above and below 1
        grads = jax.tree_util.tree_map(
            lambda a: (scale * rng.standard_normal(a.shape)).astype(
                np.float32), params)
        grads["still"] = np.zeros(3, np.float32)
        updates, jstate = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        moved.append(topt.update(
            jax.tree_util.tree_map(torch.from_numpy, grads), tstate,
            tparams))
        for got, want in zip(jax.tree_util.tree_leaves(tparams),
                             jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        if i == accumulation - 1:  # the first update: lr 0
            for got, want in zip(jax.tree_util.tree_leaves(tparams),
                                 jax.tree_util.tree_leaves(params)):
                np.testing.assert_array_equal(got.numpy(), want)
    assert moved == [(i + 1) % accumulation == 0
                     for i in range(5 * accumulation)]
    assert tstate["count"] == 5
    assert not np.allclose(tparams["still"].numpy(), params["still"])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

FLAG_SETS = {
    "unet_lora": dict(preset="attention_mlp", dropout=0.3),
    "text_lora": dict(text=True),
    "dreambooth": dict(dreambooth=True),
    "visual_influence": dict(proj=True),
    "unfrozen": dict(unfrozen=True),
    "all_accumulated": dict(preset="attention_mlp", dropout=0.3, text=True,
                            dreambooth=True, proj=True, unfrozen=True,
                            accumulation=2),
}


def _nudged(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), tree)


@functools.lru_cache(maxsize=None)
def _jax_frozen(vocab: int | None):
    """polyp_tpu's SDComponents over the tiny stack (built once a vocab
    size, so the jitted step is traced once a flag set)."""
    unet, up, vae, vp, text, tp = jax_tiny_stack()
    if vocab is not None:
        text = JCLIP(dataclasses.replace(text.config, vocab_size=vocab))
    return jsf.SDComponents(
        unet_params=up, vae_params=vp, text_params=tp,
        unet_apply=lambda p, x, t, c: unet.apply({"params": p}, x, t, c),
        vae_encode=lambda p, x: vae.apply({"params": p}, x,
                                          method=vae.encode_moments),
        text_apply=lambda p, ids: text.apply({"params": p}, ids))


def _setup(flags: dict, num_epochs: int = 1, steps_per_epoch: int = 4):
    """Both packages' (config, LoRA configs, state, frozen) for `flags`,
    and the prompt and special ids."""
    _, up, _, _, _, tp = jax_tiny_stack()
    preset = flags.get("preset", "attention")
    dropout = flags.get("dropout", 0.0)
    acc = flags.get("accumulation", 1)
    k = jax.random.PRNGKey(11)
    lc = jsurg.LoRAConfig(4, None, dropout, LORA_MODULE_PRESETS[preset])
    tc = (jsurg.LoRAConfig(4, None, 0.3, TEXT_TARGETS)
          if flags.get("text") else None)
    ids = np.random.default_rng(51).integers(0, 500, (1, L)).astype(np.int32)
    special_ids = None
    jfrozen = _jax_frozen(None)
    text_params = tp
    if flags.get("dreambooth"):
        text_params = jdb.resize_token_embeddings(tp, 513,
                                                  jax.random.fold_in(k, 3))
        text_params = jax.tree_util.tree_map(np.asarray, text_params)
        jfrozen = _jax_frozen(513).replace(text_params=text_params)
        special_ids = np.array([512], np.int32)
        ids[0, 4] = 512
    bundle = jsf.init_trainable(
        _nudged(jsurg.init_lora(up, lc, k), 52),
        _nudged(jsurg.init_lora(text_params, tc, jax.random.fold_in(k, 1)),
                53) if tc else None,
        jsf.init_proj_params(jax.random.fold_in(k, 2), 4, 32)
        if flags.get("proj") else None,
        np.asarray(text_params["token_embedding"][:1]) + 0.01
        if flags.get("dreambooth") else None,
        jpart.extract_by_mask(up, jpart.path_mask(
            up, ["to_q", "to_k", "to_v", "to_out"]))
        if flags.get("unfrozen") else None)
    bundle = jax.tree_util.tree_map(np.asarray, bundle)
    jcfg = JConfig(learning_rate=LR, num_epochs=num_epochs,
                   accumulation_steps=acc).with_schedule(steps_per_epoch)
    jstate = jsf.create_sd_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, bundle))

    stack = port_tiny_stack()
    tbundle = timp.trainable_from_jax(bundle)
    table = (timp.clip_text_from_jax(text_params)[tsf.TOKEN_TABLE]
             if flags.get("dreambooth") else None)
    tfrozen = make_components(stack, tbundle, token_table=table)
    tcfg = DiffusionConfig(learning_rate=LR, num_epochs=num_epochs,
                           accumulation_steps=acc).with_schedule(
                               steps_per_epoch)
    tstate = tsf.create_sd_train_state(tcfg, tbundle)
    tlc = tsurg.LoRAConfig(4, None, dropout, lc.target_modules)
    ttc = tsurg.LoRAConfig(4, None, 0.3, TEXT_TARGETS) if tc else None
    return dict(jcfg=jcfg, lc=lc, tc=tc, jstate=jstate, jfrozen=jfrozen,
                tcfg=tcfg, tlc=tlc, ttc=ttc, tstate=tstate, tfrozen=tfrozen,
                stack=stack, ids=ids, special_ids=special_ids,
                bundle=tbundle)


def _close_by_entry(got: dict, want: dict, rel: float):
    """max |got − want| ≤ rel · max |want| within each bundle entry."""
    for key in want:
        g = torch.cat([t.detach().reshape(-1) for t in tree_leaves(got[key])])
        w = torch.cat([t.reshape(-1) for t in tree_leaves(want[key])])
        scale = w.abs().max().item()
        assert scale > 0, key
        err = (g - w).abs().max().item()
        assert err <= rel * scale, (key, err, scale)


def _jax_tree(tree) -> dict:
    return timp.trainable_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_sd_lora_train_step_matches_jax(name):
    """Micro-steps of both steps: the loss of each, the gradients of the
    first (the reference's first Adam moment, 0.1 · the clipped gradient;
    under accumulation its accumulated mean, the raw gradient), and the
    bundle after the update at lr > 0 (the second)."""
    flags = FLAG_SETS[name]
    s = _setup(flags)
    acc = flags.get("accumulation", 1)
    images = np.random.default_rng(54).integers(0, 256, (2, 32, 32, 3),
                                                dtype=np.uint8)
    jschedule, tschedule = JSchedule.create(**SD), DiffusionSchedule.create(
        **SD)
    jsids = jnp.asarray(s["special_ids"] if s["special_ids"] is not None
                        else np.zeros(1, np.int32))
    tsids = (None if s["special_ids"] is None
             else torch.from_numpy(s["special_ids"]).long())
    before = {k: tsf._zip_tree(v, [t.detach().clone()
                                   for t in tree_leaves(v)])
              for k, v in s["tstate"].trainable.items()}
    jstate, tstate = s["jstate"], s["tstate"]
    for i in range(2 * acc):
        key = jax.random.PRNGKey(100 + i)
        jstate, jloss = jsf.sd_lora_train_step(
            jstate, s["jfrozen"], jschedule, jnp.asarray(images),
            jnp.asarray(s["ids"]), jsids, key, s["lc"], s["tc"], 1.0, 0.1)
        tstate, tloss = tsf.sd_lora_train_step(
            tstate, s["tfrozen"], tschedule, torch.from_numpy(images),
            torch.from_numpy(s["ids"]).long(), tsids, JaxDraws(key),
            s["tlc"], s["ttc"], 1.0, 0.1)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        if i == 0:
            if acc > 1:
                want = _jax_tree(jstate.opt_state.acc_grads)
                got = tstate.opt_state["acc"]
            else:
                want = _jax_tree(jstate.opt_state[1][0].mu)
                got = tstate.opt_state["mu"]
            _close_by_entry(got, want, 1e-4)
    assert tstate.opt_state["count"] == 2 and tstate.step == 2 * acc
    jafter = _jax_tree(jstate.trainable)
    for key in jafter:
        for g, w, b in zip(tree_leaves(tstate.trainable[key]),
                           tree_leaves(jafter[key]),
                           tree_leaves(before[key])):
            moved = (w - b).abs().max().item()
            assert moved > 0.5 * LR, key  # the second update moved it
            err = ((g.detach() - b) - (w - b)).abs().max().item()
            assert err <= 1e-2 * LR, (key, err)
