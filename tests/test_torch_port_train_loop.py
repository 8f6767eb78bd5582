"""The LoRA trainer's epoch loop in polyp_tpu_torch against polyp_tpu's on
the CPU (`train_sd_lora` over two epochs), resume, the DreamBooth helpers,
and the frozen stack's weights through training and merged sampling.

The set-up (the same weights, bundle and random draws in both packages)
and the tolerances are tests/test_torch_port_train.py's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.data import pipeline as jpipe
from polyp_tpu.diffusion import DiffusionSchedule as JSchedule
from polyp_tpu.models.clip_tokenizer import HashTokenizer as JHashTokenizer
from polyp_tpu.train import dreambooth as jdb
from polyp_tpu.train import sd_finetune as jsf
from polyp_tpu.utils.rng import key_for
from polyp_tpu_torch.cli.common import load_sd_stack
from polyp_tpu_torch.cli.sd_common import (
    make_components, make_sampler, merged_stack)
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.data import pipeline as tpipe
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.lora import surgery as tsurg
from polyp_tpu_torch.models import HashTokenizer
from polyp_tpu_torch.train import dreambooth as tdb
from polyp_tpu_torch.train import resume as tresume
from polyp_tpu_torch.train import sd_finetune as tsf
from polyp_tpu_torch.utils.checkpoint import tree_leaves
from test_torch_port_lora import jax_tiny_stack, port_tiny_stack
from test_torch_port_train import (
    FLAG_SETS, LR, SD, TEXT_TARGETS, L, JaxDraws, _jax_tree, _setup)


# ---------------------------------------------------------------------------
# the epoch loop, resume, and the frozen stack
# ---------------------------------------------------------------------------

def _images(n, seed=55):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


def test_train_sd_lora_two_epochs_matches_jax(monkeypatch):
    """Two epochs of 6 images at batch 4 (the second batch padded) through
    both epoch loops, each with its own Loader (the same batches) and the
    reference's step keys `key_for(seed, "sd_lora", epoch, step)`: the
    epoch losses and the final adapter."""
    s = _setup(FLAG_SETS["unet_lora"], num_epochs=2, steps_per_epoch=2)
    images, labels = _images(6), np.zeros(6, np.int32)
    monkeypatch.setattr(tsf, "step_draws", lambda seed, epoch, step, device:
                        JaxDraws(key_for(seed, "sd_lora", epoch, step)))
    jstate, jres = jsf.train_sd_lora(
        s["jcfg"], s["jstate"], s["jfrozen"], JSchedule.create(**SD),
        jpipe.Loader(images, labels, 4, seed=0), s["ids"], s["lc"])
    tstate, tres = tsf.train_sd_lora(
        s["tcfg"], s["tstate"], s["tfrozen"], DiffusionSchedule.create(**SD),
        tpipe.Loader(images, labels, 4, seed=0, device="cpu"), s["ids"],
        s["tlc"])
    np.testing.assert_allclose(tres.loss_hist, jres.loss_hist, rtol=1e-5)
    assert tstate.step == 4 and tstate.opt_state["count"] == 4
    want = _jax_tree(jstate.trainable)["unet_lora"]
    before = s["bundle"]["unet_lora"]
    for name, f in want.items():
        for k, w in f.items():
            g = tstate.trainable["unet_lora"][name][k].detach()
            assert ((g - w).abs().max() <= 2e-2 * LR), (name, k)
            assert (w - before[name][k]).abs().max() > 0.5 * LR


class Crash(Exception):
    pass


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """Three epochs in one run, and the same run cut after epoch 1's
    snapshot and restarted from it (a new state, a new Loader; the
    checkpointer restores the state and loss history and fast-forwards
    the Loader): the same bundle, optimizer state and losses, bit for
    bit."""
    images, labels = _images(6, 56), np.zeros(6, np.int32)
    schedule = DiffusionSchedule.create(**SD)

    stack = port_tiny_stack()
    ids = np.random.default_rng(58).integers(0, 500, (1, L))
    cfg = DiffusionConfig(learning_rate=LR, num_epochs=3, lora_dropout=0.3,
                          lora_preset="attention_mlp").with_schedule(2)
    lc = tsurg.LoRAConfig(4, None, 0.3, cfg.modules_lora)

    def run(checkpointer=None, crash_after=None):
        bundle = tsf.init_trainable(tsurg.init_lora(
            stack.unet, lc, torch.Generator().manual_seed(12)))

        def cut(epoch, state):
            if epoch == crash_after:
                raise Crash

        return tsf.train_sd_lora(
            cfg, tsf.create_sd_train_state(cfg, bundle),
            make_components(stack, bundle), schedule,
            tpipe.Loader(images, labels, 4, seed=0, device="cpu"), ids, lc,
            checkpointer=checkpointer, epoch_callback=cut)

    whole, whole_res = run()
    ckpt = tresume.EpochCheckpointer(tmp_path / "ckpt", every=1, keep=2)
    with pytest.raises(Crash):
        run(ckpt, crash_after=1)
    assert ckpt.latest_epoch() == 1
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("epoch_*")) == [
        "epoch_0.pt", "epoch_1.pt"]
    resumed, res = run(ckpt)
    assert res.loss_hist == whole_res.loss_hist and len(res.loss_hist) == 3
    assert resumed.step == whole.step == 6
    for tree in ("trainable", "opt_state"):
        a = tree_leaves(getattr(resumed, tree) if tree == "trainable"
                        else {k: v for k, v in resumed.opt_state.items()
                              if k != "count"})
        b = tree_leaves(getattr(whole, tree) if tree == "trainable"
                        else {k: v for k, v in whole.opt_state.items()
                              if k != "count"})
        assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(a, b))
    assert resumed.opt_state["count"] == whole.opt_state["count"]
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("epoch_*")) == [
        "epoch_1.pt", "epoch_2.pt"]
    state, epoch = tresume.resume_or_init(ckpt, whole.tree())
    assert epoch == 3 and state["step"] == 6


def test_training_and_merged_sampling_leave_the_stack_bit_equal():
    """A bf16 stack (random init, CPU) trained with every flag on for two
    steps, then sampled with the bundle merged: the adapter's B is 0 after
    step 1 (lr 0) and not after step 2; the trainables are copies, never
    views of the stack; every base weight is bit-equal before and after."""
    stack = load_sd_stack(None, dtype=torch.bfloat16, tiny=True,
                          device="cpu", seed=7)
    before = {(m, k): v.clone() for m in ("unet", "vae", "text")
              for k, v in getattr(stack, m).state_dict().items()}
    g = torch.Generator().manual_seed(8)
    cfg = DiffusionConfig(image_size=32, learning_rate=LR, num_epochs=1,
                          lora_dropout=0.3).with_schedule(2)
    lc = tsurg.LoRAConfig(4, None, 0.3, cfg.modules_lora)
    tc = tsurg.LoRAConfig(4, None, 0.0, TEXT_TARGETS)
    stack.tokenizer.add_tokens(["sks"])
    table = tdb.resize_token_embeddings(
        stack.text.get_parameter(tsf.TOKEN_TABLE), len(stack.tokenizer), g)
    sid = stack.tokenizer.convert_tokens_to_ids("sks")
    unfrozen = stack.fp32_params("unet", [
        n for n, _ in stack.unet.named_parameters() if "to_out" in n])
    bundle = tsf.init_trainable(
        tsurg.init_lora(stack.unet, lc, g), tsurg.init_lora(stack.text, tc, g),
        tsf.init_proj_params(g, 4, 32),
        tdb.dreambooth_token_init(table, stack.tokenizer, "AD")[None],
        unfrozen)
    frozen = make_components(stack, bundle, token_table=table)
    state = tsf.create_sd_train_state(cfg, bundle)
    stack_ptrs = {p.data_ptr() for m in (stack.unet, stack.text)
                  for p in m.parameters()}
    assert not stack_ptrs & {t.data_ptr() for t in tree_leaves(
        state.trainable)}
    prompt = tdb.dreambooth_prompt("AD", False, False, True)
    ids = torch.as_tensor(stack.tokenizer([prompt]))
    assert sid in ids
    b_norm = []
    for step in range(2):
        state, loss = tsf.sd_lora_train_step(
            state, frozen, DiffusionSchedule.create(**SD),
            torch.from_numpy(_images(2, 57 + step)), ids,
            torch.tensor([sid]), tsf.step_draws(0, 0, step, "cpu"), lc, tc)
        assert torch.isfinite(loss)
        b_norm.append(sum(f["lora_B"].abs().sum().item()
                          for f in state.trainable["unet_lora"].values()))
    assert b_norm[0] == 0.0 and b_norm[1] > 0.0
    merged = merged_stack(stack, frozen, state.trainable, lc, tc,
                          torch.tensor([sid]))
    sampler = make_sampler(merged, DiffusionConfig(
        image_size=32, num_inference_steps=2, sampler="ddim"))
    images = sampler.for_prompt(prompt)(2, 0)
    assert images.shape == (2, 3, 32, 32) and torch.isfinite(images).all()
    base = make_sampler(stack, DiffusionConfig(
        image_size=32, num_inference_steps=2, sampler="ddim"))
    plain = tdb.dreambooth_prompt("AD", False, False, False)
    assert not torch.equal(base.for_prompt(plain)(2, 0),
                           sampler.for_prompt(plain)(2, 0))
    for (m, k), v in before.items():
        assert torch.equal(getattr(stack, m).state_dict()[k], v), (m, k)


def test_dreambooth_helpers_match_jax():
    """The grown table keeps its rows; the special token's first row and
    the prompts are the reference's (the same hash tokenizer on both
    sides); 1e-6 relative."""
    _, _, _, _, _, tp = jax_tiny_stack()
    jtok, ttok = JHashTokenizer(512, L), HashTokenizer(512, L)
    for tok in (jtok, ttok):
        tok.add_tokens(["sks"])
    grown = tdb.resize_token_embeddings(
        torch.from_numpy(tp["token_embedding"]), 513,
        torch.Generator().manual_seed(0))
    assert grown.shape == (513, 32)
    assert torch.equal(grown[:512], torch.from_numpy(tp["token_embedding"]))
    for cls in tdb.SPECIAL_TOKENS:
        for class_condition in (False, True):
            want = jdb.dreambooth_token_init(
                {"token_embedding": jnp.asarray(grown.numpy())}, jtok, cls,
                0.5, 0.5, class_condition)
            got = tdb.dreambooth_token_init(grown, ttok, cls, 0.5, 0.5,
                                            class_condition)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        for flags in ((False, False, True), (False, True, True),
                      (True, False, False), (False, False, False)):
            assert tdb.dreambooth_prompt(cls, *flags) == \
                jdb.dreambooth_prompt(cls, *flags)
        assert tdb.resume_prompt(cls, False) == jdb.resume_prompt(cls, False)
    rows = torch.zeros(1, 32, requires_grad=True)
    table = tdb.embed_with_special_rows(grown, rows, torch.tensor([512]))
    table.sum().backward()
    assert rows.grad.eq(1).all() and torch.equal(table[:512], grown[:512])


def test_remat_step_equals_the_plain_step():
    """SDComponents.with_remat (the UNet forward rerun in the backward by
    torch.utils.checkpoint) gives the same loss and gradients, bit for
    bit on the CPU: the same operations run again."""
    stack = port_tiny_stack()
    cfg = DiffusionConfig(learning_rate=LR, num_epochs=1).with_schedule(1)
    lc = tsurg.LoRAConfig(4, None, 0.3, cfg.modules_lora)
    bundle = tsf.init_trainable(tsurg.init_lora(
        stack.unet, lc, torch.Generator().manual_seed(13)))
    for f in bundle["unet_lora"].values():
        f["lora_B"] += 0.01
    frozen = make_components(stack, bundle)
    ids = torch.as_tensor(np.random.default_rng(59).integers(0, 500, (1, L)))
    results = []
    for components in (frozen, frozen.with_remat()):
        results.append(tsf.sd_lora_loss_and_grads(
            tsf.create_sd_train_state(cfg, bundle), components,
            DiffusionSchedule.create(**SD), torch.from_numpy(_images(2, 60)),
            ids, None, tsf.step_draws(0, 0, 0, "cpu"), lc))
    (loss, grads), (loss_r, grads_r) = results
    assert frozen.with_remat().remat and not frozen.remat
    assert torch.equal(loss, loss_r)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_r)):
        assert torch.equal(a, b)
