"""Tensor parallelism on the mesh's `model` axis (polyp_tpu_torch/parallel/
sharding.py and the modules' region operators) against polyp_tpu's
sharded mesh on the CPU.

* One 4-rank gloo group, `data=2 × model=2`, spawned once for the module,
  against polyp_tpu's steps jitted over make_mesh({"data": 2, "model":
  2}) on the conftest's fake devices with the reference's shard_params
  (its sd_common.py:288-297 and finetune_pretrained.py:73-78): the LoRA
  step with every flag (UNet LoRA on attention and FF, dropout, text
  LoRA, a DreamBooth row, the visual-influence projection, unfrozen
  attention projections) and finetune_pretrained's step (a UNet adapter
  alone), two updates each, the ranks taking the reference's draws for
  the global batch (recorded through the port's one-process step, as
  tests/test_torch_port_parallel.py does); the quota fan-out (for_prompt
  and generate_to_dir, five guided DDIM steps on the reference's tiny
  stack) against polyp_tpu's StableDiffusionSampler with its UNet sharded
  over the same 2 × 2 mesh (its pipeline.py:224-234), and against one
  process; and w8a8_static on a UNet with 64/128-wide levels: the
  sampler's calibration tables (made on its whole UNet) and the sharded
  UNet's own (its row-parallel layers record the model group's amax)
  against one device's, and one forward, block by block, against
  polyp_tpu's UNet sharded over the mesh under the same tables and
  against the port's whole blocks.
* In this process: the rules name by name against the reference's
  PartitionSpecs (tiny UNet and CLIP), the blocks kept whole when k does
  not divide their heads or width, the GEGLU's per-half split against
  the whole FF, and shard → assemble as the identity.

* The CLIs' own path under `data=2 × model=2` (`_cli_path`, one more
  rank function of the same group): the seeded tiny stack sharded at load
  (load_sd_stack(mesh=)), two LoRA steps with every flag, the merge on the
  trainer's own shards, a w8a8_static batch; the bytes a rank's objects
  keep against one process's with each split tensor at 1/k, the merged
  weights handed whole to one process's sampler, and one process's
  calibration key and tables.

Tolerances: losses 1e-5 relative; parameters after two updates within
1e-2 · lr of the reference's (Adam: a relative gradient difference ε
moves an element by ε · lr); the whole trainables bit-equal across the
ranks, and the gathered bundle bit-equal on every rank; fan-out images
1e-5 · max |x| against one process launching the data ranks' rows; the
sampler's calibration tables 1e-6 relative (they are one device's, bit
for bit), the sharded UNet's 1e-5 (its activations carry the row-parallel
sums' rounding through the network's depth: 1.3e-6 at the mid-block's FF);
each int8 block's output 1e-5 relative L2 of the whole block's on the same
input, and 5e-3 of the reference's sharded block's (the int8 manner of
chip_smoke.py: every block agrees to ~1e-7 but one, where an activation
on a rounding tie takes the next code, 5.6e-4).

The fan-out's five guided DDIM steps (CFG 7.5) amplify rounding, the
reference's own sharded sampler's against its one-device one as much as
the port's. So images are held to a max |Δ| of 2.5e-2 and a mean |Δ| of 2e-3 of the
images' largest value. The group reads 4.1e-3 and 2.4e-4 there against
the reference's sharded sampler and 1.5e-3 and 1.2e-4 against one
process (the files: 1 level at most, 0.08 on average); a forward that
skips g (the row-parallel partial products never summed) reads 0.74 and
0.12.

The spawned ranks import this module: its top level imports no JAX.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from polyp_tpu_torch.parallel import launch, mesh as pmesh
from polyp_tpu_torch.parallel import sharding
from test_torch_port_parallel import Recorder, Replay

WORLD, SPEC, K = 4, "data=2,model=2", 2
LR = 1e-3  # test_torch_port_train's learning rate
PROMPT = "a colon polyp"
LORA_FLAGS = dict(preset="attention_mlp", dropout=0.1, text=True,
                  dreambooth=True, proj=True, unfrozen=True)
QUANT_POINTS = 3
FAN_STEPS = 5
FAN_SCHEDULE = dict(num_train_timesteps=50, beta_schedule="scaled_linear",
                    beta_start=0.00085, beta_end=0.012)
# generate_to_dir's batches in the fan-out: (batch, seed)
FAN_BATCHES = ((4, 3), (4, 5), (2, 6))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file and its ranks (the parallel
    test's reason: the tiny models' many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the ranks' work (one spawned group for the module)
# ---------------------------------------------------------------------------

def _steps(mesh, p):
    """Two LoRA steps on this rank's rows and shards; the gathered bundle
    (saved by rank 0 when `p["save"]`), the checksums of the whole
    trainables this rank holds and of the gathered tree, and whether a
    state restored from the gathered tree gives back its bits."""
    from polyp_tpu_torch.lora.surgery import save_lora
    from polyp_tpu_torch.train import sd_finetune as tsf
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    layout = tsf.trainable_layout(p["bundle"], p["frozen"], mesh)
    state = tsf.create_sd_train_state(p["cfg"], p["bundle"], layout, mesh)
    frozen = p["frozen"].on_mesh(mesh)
    losses = []
    for images, calls in zip(p["images"], p["draws"]):
        state, loss = tsf.sd_lora_train_step(
            state, frozen, p["schedule"], mesh.local(images), p["ids"],
            p["special_ids"], Replay(calls), p["lcfg"], p["tcfg"], 1.0, 0.1,
            mesh=mesh)
        losses.append(loss.item())
    tree = state.tree()
    again = tsf.create_sd_train_state(p["cfg"], p["bundle"], layout, mesh)
    again.restore(tree)
    leaves, kinds = tree_leaves(state.trainable), tree_leaves(layout)
    whole = [t for t, s in zip(leaves, kinds)
             if not isinstance(s, sharding.Split)]
    if p.get("save") and pmesh.is_writer(mesh):
        save_lora(p["save"], tree["trainable"])
    pmesh.barrier(mesh)
    return {"losses": losses,
            "trainable": [t.detach() for t in
                          tree_leaves(tree["trainable"])],
            "split": sum(isinstance(s, sharding.Split) for s in kinds),
            "local_numel": sum(t.numel() for t in leaves),
            "whole_checksum": pmesh.checksum(whole),
            "tree_checksum": pmesh.checksum(tree),
            "resumed": pmesh.checksum(again.tree()) == pmesh.checksum(tree)}


def _tiny_sampler(stack, mesh=None):
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.pipeline import StableDiffusionSampler

    return StableDiffusionSampler(
        stack.unet, stack.vae, stack.text, stack.tokenizer,
        DiffusionSchedule.create(**FAN_SCHEDULE), image_size=16,
        num_steps=FAN_STEPS, guidance_scale=7.5, sampler="ddim", mesh=mesh)


def _fan_out(mesh, p):
    from polyp_tpu_torch.pipeline import generate_to_dir

    sampler = _tiny_sampler(p["stack"], mesh)
    fn = sampler.for_prompt(PROMPT)
    images = fn(4, 3)
    written = generate_to_dir(fn, 6, p["out_dir"], 4, seed=5, mesh=mesh)
    return {"images": images, "written": written,
            "gathered": pmesh.checksum(sharding.gather_params(sampler.unet)),
            "sharded": sharding.sharded(sampler.unet) is mesh}


def _per_layer_ff(ff, x):
    """A FeedForward through its two QLinears one by one."""
    a, gate = ff.net[0].proj(x).chunk(2, dim=-1)
    return ff.net[2](a * torch.nn.functional.gelu(gate))


def _block_errors(tp_unet, whole_unet, forward, bank, t,
                  mode: str = "w8a8_static") -> dict:
    """One int8 forward of the sharded UNet, each Attention and
    FeedForward call captured with its input and output and re-run by
    the whole UNet's block on that input (a whole FF per layer under
    dynamic w8a8, the path the sharded FF takes): the worst relative L2,
    the per-token GEGLU's calls in the sharded forward, and the captured
    calls by the reference's module path."""
    from polyp_tpu_torch.models import importers as timp
    from polyp_tpu_torch.models import unet_blocks
    from polyp_tpu_torch.models.unet_blocks import Attention, FeedForward
    from polyp_tpu_torch.ops import quant

    calls, per_token = [], []
    plain = unet_blocks.fused_geglu_w8a8_pt

    def capture(name):
        def hook(module, args, output):
            calls.append((name, [a.detach().clone() for a in args],
                          output.detach().clone()))
        return hook

    def recording(*args):
        per_token.append(1)
        return plain(*args)

    hooks = [m.register_forward_hook(capture(name))
             for name, m in tp_unet.named_modules()
             if isinstance(m, (Attention, FeedForward))]
    unet_blocks.fused_geglu_w8a8_pt = recording
    try:
        with torch.no_grad(), quant.override(mode, scales=bank, t=t):
            out = forward(tp_unet)
    finally:
        unet_blocks.fused_geglu_w8a8_pt = plain
        for h in hooks:
            h.remove()
    worst = 0.0
    with torch.no_grad(), quant.override(mode, scales=bank, t=t):
        for name, args, got in calls:
            block = whole_unet.get_submodule(name)
            want = (_per_layer_ff(block, *args)
                    if mode == "w8a8" and isinstance(block, FeedForward)
                    else block(*args))
            worst = max(worst, ((got - want).norm() / want.norm()).item())
    return {"blocks": len(calls), "worst_rel_l2": worst,
            "per_token_calls": len(per_token),
            "finite": bool(torch.isfinite(out).all()),
            "calls": {timp.jax_module_path(name): (args, got)
                      for name, args, got in calls}}


def _quant_sampler(unet, schedule, mesh=None):
    from polyp_tpu_torch.pipeline import StableDiffusionSampler

    return StableDiffusionSampler(unet, None, None, None, schedule,
                                  image_size=64, num_steps=QUANT_POINTS,
                                  sampler="ddim", quantize="w8a8_static",
                                  mesh=mesh)


def _w8a8(mesh, p):
    """The TP sampler's calibration tables, the sharded quant UNet's own,
    and its w8a8_static forward block by block under the one-process
    tables."""
    import os

    from polyp_tpu_torch.diffusion import calibrate as tcal
    from polyp_tpu_torch.ops import quant

    os.environ["POLYP_TORCH_QUANT_CACHE"] = os.path.join(
        p["cache"], f"rank{mesh.world_rank}")
    unet = p["unet"]
    sampler = _quant_sampler(unet, p["schedule"], mesh)
    sampler._ensure_calibrated(p["cond"], p["uncond"])
    tp_unet = sampler.unet
    tables = tcal.calibrate_unet_scales(
        tp_unet, p["schedule"], (2, 4, 8, 8), p["cond"], p["uncond"],
        num_steps=QUANT_POINTS)
    x, t, ctx = p["inputs"]
    errors = _block_errors(tp_unet, unet, lambda m: m(x, t, ctx),
                           quant.ScaleBank(p["tables"]), t)
    dynamic = _block_errors(tp_unet, unet, lambda m: m(x, t, ctx), None, t,
                            mode="w8a8")
    return {"sampler_tables": sampler.quant_scales, "tables": tables,
            "sharded": sharding.sharded(tp_unet) is mesh, **errors,
            "dynamic": {k: v for k, v in dynamic.items() if k != "calls"}}


def _storage_bytes(*roots) -> dict[int, int]:
    """{storage address: bytes} of every tensor reachable from `roots`
    through modules, dataclasses, dicts and sequences (callables, meshes
    and generators not followed): what those objects keep resident."""
    from polyp_tpu_torch.parallel.mesh import DataMesh

    leaves = (str, bytes, int, float, bool, torch.device, torch.dtype,
              DataMesh, torch.Generator, type, np.ndarray)
    seen, out, todo = set(), {}, list(roots)
    while todo:
        o = todo.pop()
        if o is None or id(o) in seen or isinstance(o, leaves) or (
                callable(o) and not isinstance(o, torch.nn.Module)):
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            storage = o.untyped_storage()
            out[storage.data_ptr()] = storage.nbytes()
        elif isinstance(o, dict):
            todo.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            todo.extend(o)
        elif hasattr(o, "__dict__"):
            todo.extend(vars(o).values())
    return out


def _shapes(*modules) -> list[dict]:
    return [{n: tuple(p.shape) for n, p in m.named_parameters()}
            for m in modules]


def _cli_objects(mesh, p):
    """The CLIs' path (cli/sd_common.py::train_class under `--mesh
    data=2,model=2`; None: one process) on the seeded tiny stack:
    load_sd_stack(mesh=) → the bundle (UNet LoRA on attention and FF,
    dropout, text LoRA, a DreamBooth row, unfrozen attention projections)
    → make_components → on_mesh → two sd_lora_train_steps → merged_stack
    on the trainer's own state → make_sampler → one w8a8_static batch:
    the stack, components, trainer state, sampler and batch."""
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.cli.sd_common import (
        UNFROZEN_MODULES, make_components, make_sampler, merged_stack)
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.lora.surgery import init_lora
    from polyp_tpu_torch.train import sd_finetune as tsf
    from polyp_tpu_torch.train.dreambooth import resize_token_embeddings
    from polyp_tpu_torch.utils.rng import stream_generator

    stack = load_sd_stack(None, dtype=torch.float32, tiny=True,
                          device="cpu", seed=0, mesh=mesh)

    def gen(i):
        return stream_generator(0, "lora_init", i, device="cpu")

    table = stack.text.get_parameter(tsf.TOKEN_TABLE)
    rows = table.shape[0]
    grown = resize_token_embeddings(table, rows + 1, gen(3))
    trainable = pmesh.replicate_to(tsf.init_trainable(
        init_lora(stack.unet, p["lcfg"], gen(0)),
        init_lora(stack.text, p["tcfg"], gen(1)),
        special_rows=grown[-1:].clone(),
        unfrozen=stack.fp32_params("unet", [
            n for n, _ in stack.unet.named_parameters()
            if any(m in n for m in UNFROZEN_MODULES)], whole=True)), mesh)
    frozen = make_components(stack, trainable, token_table=grown)
    state = tsf.create_sd_train_state(
        p["cfg"], trainable, tsf.trainable_layout(trainable, frozen, mesh),
        mesh)
    del trainable
    frozen = frozen.on_mesh(mesh)
    ids = torch.as_tensor(stack.tokenizer([PROMPT]))
    ids[0, 1] = rows
    special = torch.tensor([rows])
    schedule = DiffusionSchedule.create(**FAN_SCHEDULE)
    losses = []
    for step, images in enumerate(p["images"]):
        state, loss = tsf.sd_lora_train_step(
            state, frozen, schedule,
            images if mesh is None else mesh.local(images), ids, special,
            tsf.step_draws(0, 0, step, "cpu"), p["lcfg"], p["tcfg"],
            mesh=mesh)
        losses.append(loss.item())
    merged = merged_stack(stack, frozen, state.trainable, p["lcfg"],
                          p["tcfg"], special)
    sampler = make_sampler(merged, p["sampler"], mesh=mesh)
    images = sampler.for_prompt(PROMPT)(4, 3)
    return dict(stack=stack, frozen=frozen, state=state, merged=merged,
                sampler=sampler, images=images, losses=losses)


def _cli_path(mesh, p):
    """`_cli_objects` on this rank, with `sharding.sharded_copy` refused:
    the bytes its objects keep (and with one whole split kernel more),
    the split modules' parameter shapes, the batch, the merged weights
    gathered, the calibration key and tables, and the tables again after
    model rank 1 alone lost its cache file (the group must take the miss
    together)."""
    import os

    from polyp_tpu_torch.cli.sd_common import make_sampler
    from polyp_tpu_torch.diffusion import calibrate as tcal

    os.environ["POLYP_TORCH_QUANT_CACHE"] = os.path.join(
        p["cache"], f"cli{mesh.world_rank}")
    allowed = sharding.sharded_copy

    def refused(*args, **kwargs):
        raise AssertionError("the CLIs' path reached sharded_copy")

    sharding.sharded_copy = refused
    try:
        o = _cli_objects(mesh, p)
        stack, sampler = o["stack"], o["sampler"]
        roots = (stack, o["frozen"], o["state"], sampler)
        extra = stack.fp32_params("unet", [p["whole_kernel"]], whole=True)
        if mesh.model_rank == 1:
            os.remove(tcal.default_scales_cache(sampler.calibration_key))
        again = make_sampler(o["merged"], p["sampler"], mesh=mesh)
        cond = sampler.encode_prompt(PROMPT)
        again._ensure_calibrated(cond, sampler.encode_prompt(""))
    finally:
        sharding.sharded_copy = allowed
    return {**_fp32_slices(mesh, p),
            "bundle": o["state"].whole_trainable(),
            "bytes": sum(_storage_bytes(*roots).values()),
            "bytes_with_a_whole_kernel": sum(_storage_bytes(
                *roots, extra).values()),
            "shapes": _shapes(stack.unet, stack.text, sampler.unet,
                              sampler.text_model),
            "sharded": [sharding.sharded(m) is mesh for m in (
                stack.unet, stack.text, o["frozen"].unet, o["frozen"].text,
                sampler.unet, sampler.text_model)],
            "vae_whole": sharding.sharded(stack.vae) is None,
            "sampler_keeps_no_whole_unet": sampler.whole_unet is None,
            "images": o["images"], "losses": o["losses"],
            "merged_unet": sharding.gather_params(sampler.unet),
            "merged_text": sharding.gather_params(sampler.text_model),
            "key": sampler.calibration_key,
            "cond": cond, "uncond": sampler.encode_prompt(""),
            "tables": sampler.quant_scales,
            "tables_after_one_miss": again.quant_scales}


def _fp32_slices(mesh, p):
    """A bf16 stack loaded sharded from the seed (replayed) and from a
    diffusers checkpoint: `fp32_params` of the split parameters
    (`p["fp32_names"]`), this rank's slices, and whether each rounds to
    the stack's own shard."""
    from polyp_tpu_torch.cli.common import load_sd_stack

    fp32, rounds = {}, True
    for source, root in (("replay", None), ("checkpoint", p["ckpt"])):
        low = load_sd_stack(root, dtype=torch.bfloat16, tiny=True,
                            device="cpu", seed=0, mesh=mesh)
        fp32[source] = {part: low.fp32_params(part, names)
                        for part, names in p["fp32_names"].items()}
        rounds &= all(
            torch.equal(v.to(torch.bfloat16),
                        getattr(low, part).get_parameter(n))
            for part, got in fp32[source].items() for n, v in got.items())
    return {"fp32": fp32, "fp32_rounds_to_the_shards": rounds}


def _group(mesh, payloads):
    return {"lora": _steps(mesh, payloads["lora"]),
            "finetune": _steps(mesh, payloads["finetune"]),
            "fan_out": _fan_out(mesh, payloads["fan_out"]),
            "w8a8": _w8a8(mesh, payloads["w8a8"]),
            "cli": _cli_path(mesh, payloads["cli"]),
            "mesh": (mesh.shape, mesh.rank, mesh.model_rank)}


# ---------------------------------------------------------------------------
# the references (this process)
# ---------------------------------------------------------------------------

def _lora_case(flags, save=None):
    """The group's payload (the port's draws recorded through its
    one-process step on the global batch), and a function computing the
    reference's steps over the 2 × 2 mesh."""
    import jax
    import jax.numpy as jnp

    from polyp_tpu.diffusion import DiffusionSchedule as JSchedule
    from polyp_tpu.parallel import (
        make_mesh, replicate_to, shard_batch, shard_params)
    from polyp_tpu.train import sd_finetune as jsf
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.train import sd_finetune as tsf
    from test_torch_port_train import SD, JaxDraws, _jax_tree, _setup

    s = _setup(flags)
    tschedule = DiffusionSchedule.create(**SD)
    rng = np.random.default_rng(55)
    images = [rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
              for _ in range(2)]
    keys = [jax.random.PRNGKey(300 + i) for i in range(2)]
    one = tsf.create_sd_train_state(s["tcfg"], s["bundle"])
    ids = torch.from_numpy(s["ids"]).long()
    sids = (None if s["special_ids"] is None
            else torch.from_numpy(s["special_ids"]).long())
    draws = []
    for key, batch in zip(keys, images):
        rec = Recorder(JaxDraws(key))
        tsf.sd_lora_train_step(one, s["tfrozen"], tschedule,
                               torch.from_numpy(batch), ids, sids, rec,
                               s["tlc"], s["ttc"], 1.0, 0.1)
        draws.append(rec.calls)
    payload = dict(cfg=s["tcfg"], bundle=s["bundle"], frozen=s["tfrozen"],
                   schedule=tschedule, ids=ids, special_ids=sids,
                   lcfg=s["tlc"], tcfg=s["ttc"], save=save,
                   images=[torch.from_numpy(b) for b in images],
                   draws=draws)

    def reference():
        mesh = make_mesh({"data": 2, "model": K}, jax.devices()[:WORLD])
        jfrozen = s["jfrozen"].replace(
            unet_params=shard_params(s["jfrozen"].unet_params, mesh),
            vae_params=replicate_to(s["jfrozen"].vae_params, mesh),
            text_params=shard_params(s["jfrozen"].text_params, mesh))
        jstate, jlosses = replicate_to(s["jstate"], mesh), []
        jsids = jnp.asarray(s["special_ids"] if s["special_ids"] is not None
                            else np.zeros(1, np.int32))
        for key, batch in zip(keys, images):
            jstate, jloss = jsf.sd_lora_train_step(
                jstate, jfrozen, JSchedule.create(**SD),
                shard_batch(jnp.asarray(batch), mesh),
                jnp.asarray(s["ids"]), jsids, key, s["lc"], s["tc"], 1.0,
                0.1)
            jlosses.append(float(jloss))
        return {"losses": jlosses, "bundle": s["bundle"],
                "after": _jax_tree(jstate.trainable)}

    return payload, reference


def _quant_case(cache):
    """The quant UNet (64/128-wide levels) with the reference's weights
    (its init nudged by N(0, 0.05²), as tests/test_torch_port_quant.py
    makes them) in both packages: the group's payload (one device's
    calibration tables, as the sampler makes them, and a forward's
    inputs) and the reference's (module, parameters)."""
    import jax
    import jax.numpy as jnp

    from polyp_tpu.models.unet_condition import UNet2DCondition as JUNet
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.diffusion import calibrate as tcal
    from polyp_tpu_torch.models import importers as timp
    from polyp_tpu_torch.models.unet_condition import UNet2DCondition
    from test_torch_port_quant import QUANT_UNET

    junet = JUNet(**QUANT_UNET, dtype=jnp.float32)
    params = junet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                        jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, 7, 64)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)
    unet = UNet2DCondition(**QUANT_UNET).eval()
    unet.load_state_dict(timp.unet_from_jax(params), strict=True)
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085,
                                        0.012)
    rng = np.random.default_rng(8)
    cond, uncond = (torch.from_numpy(rng.standard_normal(
        (1, 7, 64)).astype(np.float32)) for _ in range(2))
    tables = tcal.calibrate_unet_scales(unet, schedule, (2, 4, 8, 8), cond,
                                        uncond, num_steps=QUANT_POINTS)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(
        np.float32))
    t = torch.tensor([900, 900])
    ctx = torch.cat([cond, uncond])
    return (dict(unet=unet, schedule=schedule, cond=cond, uncond=uncond,
                 tables=tables, inputs=(x, t, ctx), cache=str(cache)),
            (junet, params))


def _reference_blocks(junet, params, tables, inputs, calls):
    """polyp_tpu's UNet with its parameters sharded over the 2 × 2 mesh
    (its shard_params), jitted under w8a8_static with the port's tables
    (by the reference's layer paths), each Attention and FeedForward call
    given the port's captured input for that block: {path: output}."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from polyp_tpu.models import unet_blocks as jb
    from polyp_tpu.ops import dispatch as jdispatch
    from polyp_tpu.ops import quant as jq
    from polyp_tpu.parallel import make_mesh, shard_params
    from polyp_tpu_torch.models import importers as timp

    scales = {timp.jax_module_path(k): v for k, v in tables.items()}
    x, t, ctx = inputs

    def forward(p, x, t, ctx, given):
        outs = {}

        def intercept(next_fun, args, kwargs, context):
            m = context.module
            path = "/".join(m.scope.path)
            if (context.method_name == "__call__" and path in given
                    and isinstance(m, (jb.Attention, jb.FeedForward))):
                outs[path] = next_fun(*given[path])
                return outs[path]
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(intercept), jq.override(
                "w8a8_static", scales=scales, t=t):
            junet.apply({"params": p}, x, t, ctx)
        return outs

    mesh = make_mesh({"data": 2, "model": K}, jax.devices()[:WORLD])
    given = {k: [jnp.asarray(a.numpy()) for a in args]
             for k, (args, _) in calls.items()}
    with jdispatch.mesh_trace_scope(mesh):
        outs = jax.jit(forward)(
            shard_params(params, mesh),
            jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
            jnp.asarray(t.numpy()), jnp.asarray(ctx.numpy()), given)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in outs.items()}


def _fan_out_reference(images_of):
    """polyp_tpu's sampler with its UNet sharded over the 2 × 2 mesh (the
    reference's tiny stack and weights, its own CLIP and tokenizer) on
    the port's initial latents of each of FAN_BATCHES: {seed: NCHW
    images}. `images_of(batch, seed)` gives those latents."""
    import jax
    import jax.numpy as jnp

    from polyp_tpu.diffusion import DiffusionSchedule as JSchedule
    from polyp_tpu.models.clip_tokenizer import HashTokenizer as JTokenizer
    from polyp_tpu.models.clip_text import TINY_TEXT_CONFIG as J_TINY_TEXT
    from polyp_tpu.parallel import make_mesh
    from polyp_tpu.pipeline import StableDiffusionSampler as JSampler
    from test_torch_port_lora import L, jax_tiny_stack

    unet, up, vae, vp, text, tp = jax_tiny_stack()
    mesh = make_mesh({"data": 2, "model": K}, jax.devices()[:WORLD])
    j = JSampler(unet, up, vae, {"params": vp}, text, {"params": tp},
                 JTokenizer(vocab_size=J_TINY_TEXT.vocab_size, max_length=L),
                 JSchedule.create(**FAN_SCHEDULE), image_size=16,
                 num_steps=FAN_STEPS, guidance_scale=7.5, sampler="ddim",
                 mesh=mesh)
    generate = jax.jit(j._generate_impl, static_argnames=("batch_size",),
                       out_shardings=j._out_shardings())
    cond, uncond = j.encode_prompt(PROMPT), j.encode_prompt("")
    out = {}
    for batch, seed in FAN_BATCHES:
        init = images_of(batch, seed).numpy().transpose(0, 2, 3, 1)
        images = generate(j.unet_params, j.decode_params, cond, uncond,
                          jax.random.PRNGKey(0), batch_size=batch,
                          init=jnp.asarray(init))
        out[seed] = torch.from_numpy(
            np.asarray(images).transpose(0, 3, 1, 2).copy())
    return out


def _fan_init(batch, seed):
    """The initial latents the port's sampler draws for (batch, seed)."""
    from polyp_tpu_torch.diffusion.samplers import _gaussian
    return _gaussian((batch, 4, 2, 2), torch.Generator().manual_seed(seed),
                     "fan-out")


def _cli_case(cache):
    """The CLI path's payload: the train config (global batch 4 at 32 px,
    two steps), its LoRA configs, the images, the w8a8_static sampler's
    config (16 px, three DDIM steps, CFG 7.5), the ranks' cache root, the
    name of a split kernel for the negative control, and a diffusers
    checkpoint of the reference's tiny weights with the split parameters'
    names of its UNet and CLIP (the fp32 slices' check)."""
    from polyp_tpu_torch.cli.common import build_modules
    from polyp_tpu_torch.configs import LORA_MODULE_PRESETS, DiffusionConfig
    from polyp_tpu_torch.lora.surgery import LoRAConfig
    from test_torch_port_lora import write_diffusers_dir

    cfg = DiffusionConfig(image_size=32, train_batch_size=4, num_epochs=1,
                          learning_rate=LR, lora_rank=4, lora_dropout=0.1,
                          lora_preset="attention_mlp").with_schedule(2)
    rng = np.random.default_rng(56)
    unet, _, text = build_modules(True, torch.float32, "meta")
    plan = sharding.unet_param_sharding(unet, K)
    ckpt = cache.parent / "sd"
    ckpt.mkdir(parents=True)
    return dict(
        cfg=cfg, lcfg=LoRAConfig(4, None, 0.1, cfg.modules_lora),
        tcfg=LoRAConfig(4, None, 0.0, LORA_MODULE_PRESETS["text_encoder"]),
        images=[torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3),
                                              dtype=np.uint8))
                for _ in range(2)],
        sampler=DiffusionConfig(image_size=16, num_inference_steps=3,
                                sampler="ddim", guidance_scale=7.5,
                                quantize="w8a8_static",
                                num_train_timesteps=50),
        cache=str(cache),
        whole_kernel=next(n for n, v in plan.items() if v is not None),
        ckpt=str(write_diffusers_dir(ckpt, "safetensors")),
        fp32_names={part: [n for n, v in sharding.unet_param_sharding(
            module, K).items() if v is not None]
            for part, module in (("unet", unet), ("text", text))})


@contextlib.contextmanager
def _quant_cache(path):
    """This process's calibration cache at `path` for the block."""
    import os

    before = os.environ.get("POLYP_TORCH_QUANT_CACHE")
    os.environ["POLYP_TORCH_QUANT_CACHE"] = str(path)
    try:
        yield
    finally:
        if before is None:
            del os.environ["POLYP_TORCH_QUANT_CACHE"]
        else:
            os.environ["POLYP_TORCH_QUANT_CACHE"] = before


def _one_process(p):
    """`_cli_objects` in this process (its calibration cache under the
    payload's cache root)."""
    with _quant_cache(f"{p['cache']}/one"):
        return _cli_objects(None, p)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The references, and the 4-rank group's results (spawned once)."""
    from test_torch_port_lora import port_tiny_stack

    tmp = tmp_path_factory.mktemp("tp")
    stack = port_tiny_stack()
    cases = {"lora": _lora_case(LORA_FLAGS, str(tmp / "bundle")),
             "finetune": _lora_case({})}
    payloads = {k: v[0] for k, v in cases.items()}
    payloads["fan_out"] = dict(stack=stack, out_dir=str(tmp / "group"))
    payloads["w8a8"], quant_reference = _quant_case(tmp / "quant_cache")
    payloads["cli"] = _cli_case(tmp / "cli_cache")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn_group, _group, WORLD, (payloads,),
                            timeout=300, spec=SPEC)
        refs = {k: v[1]() for k, v in cases.items()}
        refs["cli"] = _one_process(payloads["cli"])
        refs["fan_out"] = _fan_out_reference(_fan_init)
        refs["w8a8"] = quant_reference
        return {"refs": refs, "ranks": ranks.result(), "stack": stack,
                "tmp": tmp, "payloads": payloads}


# ---------------------------------------------------------------------------
# the group against the references
# ---------------------------------------------------------------------------

def test_the_ranks_follow_the_references_layout(group):
    """rank = d·k + m: the data and model ranks of each spawned rank."""
    got = [r["mesh"] for r in group["ranks"]]
    want = [({"data": 2, "model": K}, r // K, r % K) for r in range(WORLD)]
    assert got == want


@pytest.mark.parametrize("case", ["lora", "finetune"])
def test_tp_step_matches_the_references_mesh_step(group, case):
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    ref = group["refs"][case]
    before = tree_leaves(ref["bundle"])
    after = tree_leaves({k: ref["after"][k] for k in ref["bundle"]})
    for r in group["ranks"]:
        got = r[case]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert len(got["trainable"]) == len(after)
        for g, w, b in zip(got["trainable"], after, before):
            assert ((g - b) - (w - b)).abs().max().item() <= 1e-2 * LR
        # the shards are slices: less held than the whole bundle
        assert got["split"] > 0
        assert got["local_numel"] < sum(t.numel() for t in before)
    moved = max((w - b).abs().max().item() for w, b in zip(after, before))
    assert moved > 0.5 * LR


@pytest.mark.parametrize("case", ["lora", "finetune"])
def test_whole_trainables_are_bit_equal_across_ranks(group, case):
    ranks = [r[case] for r in group["ranks"]]
    assert len({r["whole_checksum"] for r in ranks}) == 1
    assert len({r["tree_checksum"] for r in ranks}) == 1
    assert all(r["resumed"] for r in ranks)


def test_gathered_bundle_loads_in_one_process(group):
    """Rank 0's file of the gathered bundle: the one-process bundle's
    keys and shapes, the group's bits, and it merges into the stack."""
    from polyp_tpu_torch.lora.surgery import load_lora
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    loaded = load_lora(group["tmp"] / "bundle")
    bundle = group["payloads"]["lora"]["bundle"]
    assert list(loaded) == list(bundle)
    got, want = tree_leaves(loaded), tree_leaves(bundle)
    assert [t.shape for t in got] == [t.shape for t in want]
    for a, b in zip(got, group["ranks"][0]["lora"]["trainable"]):
        assert torch.equal(a, b)


def _assert_images_close(got, want, top):
    """The fan-out's bound (module docstring): max |Δ| 2.5e-2 and mean
    |Δ| 2e-3 of the images' largest value `top`."""
    diff = (got - want).abs()
    assert got.shape == want.shape
    assert diff.max().item() <= 2.5e-2 * top, diff.max().item() / top
    assert diff.mean().item() <= 2e-3 * top, diff.mean().item() / top


def test_tp_fan_out_matches_the_references_sharded_sampler(group):
    """The group's images (on every rank) and rank 0's files against
    polyp_tpu's sampler with its UNet sharded over the 2 × 2 mesh, on the
    same initial latents: five guided DDIM steps."""
    from PIL import Image

    from polyp_tpu_torch.pipeline import images_uint8

    ref = group["refs"]["fan_out"]
    top = ref[3].abs().max().item()
    for r in group["ranks"]:
        assert r["fan_out"]["images"].shape == (4, 3, 16, 16)
        _assert_images_close(r["fan_out"]["images"], ref[3], top)
        assert r["fan_out"]["written"] == 6
    files = group["tmp"] / "group"
    assert sorted(p.name for p in files.iterdir()) == sorted(
        f"{i}.png" for i in range(1, 7))
    # generate_to_dir's batches: seed 5 (4 images), seed 6 (2 images)
    want = torch.cat([ref[5], ref[6]])
    got = torch.from_numpy(np.stack([
        np.asarray(Image.open(files / f"{i + 1}.png"), np.float32)
        for i in range(6)]))
    # levels: [-1, 1] is 127.5 levels a unit, and the PNG rounds (≤ 1)
    diff = (got - images_uint8(want).float()).abs()
    assert diff.max().item() <= 2.5e-2 * top * 127.5 + 1
    assert diff.mean().item() <= 2e-3 * top * 127.5 + 0.5


def test_the_fan_out_bound_refuses_a_skipped_g(group):
    """Rank 0's forward without g (each attention out-projection and FF
    down-projection on its half of the input features alone, the bias
    once): one process with the other halves of those weights zeroed.
    Its images leave the bound against the reference (0.74 and 0.12)."""
    import copy

    from polyp_tpu_torch.parallel.dryrun import launched_as_ranks

    stack = copy.deepcopy(group["stack"])
    with torch.no_grad():
        for name, m in stack.unet.named_modules():
            if name.endswith(("to_out.0", "ff.net.2")):
                m.weight[:, m.weight.shape[1] // 2:] = 0
    sampler = _tiny_sampler(stack)
    got = launched_as_ranks(sampler, sampler.encode_prompt(PROMPT),
                            _fan_init(4, 3), 2)
    want = group["refs"]["fan_out"][3]
    with pytest.raises(AssertionError):
        _assert_images_close(got, want, want.abs().max().item())
    assert (got - want).abs().mean().item() > 0.05 * want.abs().max().item()


def test_gather_params_rebuilds_the_whole_unet(group):
    """The sampler's sharded UNet gathered on every rank: the one-process
    UNet's parameters, bit for bit."""
    whole = {k: v.detach() for k, v in group["stack"].unet.named_parameters()}
    for r in group["ranks"]:
        assert r["fan_out"]["sharded"]
        assert r["fan_out"]["gathered"] == pmesh.checksum(whole)


def test_tp_fan_out_matches_one_process(group):
    """The same images against the port's one process launching each
    data rank's rows (dryrun.launched_as_ranks) with the whole UNet."""
    from polyp_tpu_torch.parallel.dryrun import launched_as_ranks

    sampler = _tiny_sampler(group["stack"])
    cond = sampler.encode_prompt(PROMPT)
    want = launched_as_ranks(sampler, cond, _fan_init(4, 3), 2)
    top = want.abs().max().item()
    for r in group["ranks"]:
        _assert_images_close(r["fan_out"]["images"], want, top)


@pytest.mark.parametrize("which, rtol", [("sampler_tables", 1e-6),
                                         ("tables", 1e-5)])
def test_tp_calibration_tables_match_one_device(group, which, rtol):
    want = group["payloads"]["w8a8"]["tables"]
    for r in group["ranks"]:
        assert r["w8a8"]["sharded"]
        got = r["w8a8"][which]
        assert set(got) == set(want) and len(want) > 10
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=rtol, err_msg=k)


def test_tp_w8a8_static_blocks_match_the_whole_blocks(group):
    unet = group["payloads"]["w8a8"]["unet"]
    from polyp_tpu_torch.models.unet_blocks import Attention, FeedForward
    blocks = sum(isinstance(m, (Attention, FeedForward))
                 for m in unet.modules())
    for r in group["ranks"]:
        got = r["w8a8"]
        assert got["finite"] and got["blocks"] == blocks
        assert got["worst_rel_l2"] <= 1e-5


def test_tp_w8a8_static_blocks_match_the_references_sharded_blocks(group):
    """Each rank's int8 blocks against polyp_tpu's UNet sharded over the
    2 × 2 mesh under the same tables, each block on the same input: 5e-3
    relative L2 at worst, and the median at fp32 rounding (1e-6)."""
    junet, params = group["refs"]["w8a8"]
    p = group["payloads"]["w8a8"]
    for r in group["ranks"]:
        calls = r["w8a8"]["calls"]
        want = _reference_blocks(junet, params, p["tables"], p["inputs"],
                                 calls)
        assert set(want) == set(calls) and len(calls) == r["w8a8"]["blocks"]
        errors = sorted(((got - want[k]).norm() / want[k].norm()).item()
                        for k, (_, got) in calls.items())
        assert errors[-1] <= 5e-3, errors[-1]
        assert errors[len(errors) // 2] <= 1e-6, errors


def test_tp_dynamic_w8a8_ff_runs_per_layer(group):
    """Under dynamic w8a8 a sharded FF runs its two QLinears through the
    dense (its h groups would straddle the ranks' slices), never the
    per-token GEGLU, which the same FF takes whole in one process; each
    block matches the whole block's per-layer path."""
    from polyp_tpu_torch.models import unet_blocks
    from polyp_tpu_torch.models.unet_blocks import FeedForward
    from polyp_tpu_torch.ops import quant

    p = group["payloads"]["w8a8"]
    x, t, ctx = p["inputs"]
    whole = []
    plain = unet_blocks.fused_geglu_w8a8_pt
    unet_blocks.fused_geglu_w8a8_pt = lambda *a: whole.append(1) or plain(
        *a)
    try:
        with torch.no_grad(), quant.override("w8a8"):
            p["unet"](x, t, ctx)
    finally:
        unet_blocks.fused_geglu_w8a8_pt = plain
    # every FF of the quant UNet, whole
    assert len(whole) == sum(isinstance(m, FeedForward)
                             for m in p["unet"].modules()) > 0
    for r in group["ranks"]:
        got = r["w8a8"]["dynamic"]
        assert got["finite"] and got["per_token_calls"] == 0
        assert r["w8a8"]["per_token_calls"] == 0  # w8a8_static: none
        assert got["worst_rel_l2"] <= 1e-5


def _split_storages(one: dict, k: int) -> set[int]:
    """Storage addresses of the one-process objects' tensors that a rank
    holds 1/k of: the split parameters of the stack's UNet and CLIP and of
    the merged ones, their cached int8 codes (and a column layer's weight
    scales: a row-parallel layer's are the model group's, whole), the
    split fp32 kernels, and the split trainables with their moments."""
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    stack, frozen, state, sampler = (one[key] for key in (
        "stack", "frozen", "state", "sampler"))
    split = set()

    def mark(t):
        split.add(t.untyped_storage().data_ptr())

    for module in (stack.unet, stack.text, sampler.unet, sampler.text_model):
        plan = sharding.unet_param_sharding(module, k)
        for name, param in module.named_parameters():
            if plan[name] is not None:
                mark(param)
        for name, sub in module.named_modules():
            codes, cut = sub.__dict__.get("_q8_weight"), plan.get(
                f"{name}.weight")
            if codes is not None and cut is not None:
                mark(codes[1])
                if cut.dim == 0:
                    mark(codes[2])
    for part, params in (("unet", frozen.unet_params),
                         ("text", frozen.text_params)):
        plan = sharding.unet_param_sharding(getattr(stack, part), k)
        for name, t in params.items():
            if plan.get(name) is not None:
                mark(t)
    layout = tree_leaves(sharding.trainable_sharding(
        state.trainable, stack.unet, stack.text, k))
    for tree in (state.trainable, state.opt_state["mu"],
                 state.opt_state["nu"]):
        for t, cut in zip(tree_leaves(tree), layout):
            if isinstance(cut, sharding.Split):
                mark(t)
    return split


def test_cli_path_rank_holds_only_its_shards(group):
    """A rank on the CLIs' path keeps exactly one process's bytes (stack,
    components, trainer state, sampler, after a w8a8_static batch) with
    each split tensor counted at 1/k; with one whole split kernel more
    it fails that count. Every split parameter has its shard's shape."""
    one = group["refs"]["cli"]
    held = _storage_bytes(one["stack"], one["frozen"], one["state"],
                          one["sampler"])
    split = _split_storages(one, K)
    assert split and split <= set(held)
    want = sum(b // K if ptr in split else b for ptr, b in held.items())
    assert want < sum(held.values())
    modules = (one["stack"].unet, one["stack"].text, one["sampler"].unet,
               one["sampler"].text_model)
    shapes = []
    for module, whole in zip(modules, _shapes(*modules)):
        plan = sharding.unet_param_sharding(module, K)
        shapes.append({n: tuple(d // K if plan[n] is not None
                                and i == plan[n].dim else d
                                for i, d in enumerate(shape))
                       for n, shape in whole.items()})
    for r in group["ranks"]:
        got = r["cli"]
        assert got["bytes"] == want
        assert got["bytes_with_a_whole_kernel"] > want
        assert got["shapes"] == shapes


def test_cli_path_keeps_no_whole_copy(group):
    """The stack's UNet and CLIP, the components' and the merged ones are
    sharded over the group's mesh (sharded_copy, refused on the ranks, was
    never reached), the VAE is whole, and the sampler keeps no whole UNet;
    the whole merged weights are bit-equal across the ranks."""
    for r in group["ranks"]:
        got = r["cli"]
        assert all(got["sharded"]) and len(got["sharded"]) == 6
        assert got["vae_whole"] and got["sampler_keeps_no_whole_unet"]
    assert len({pmesh.checksum([r["cli"]["merged_unet"],
                                r["cli"]["merged_text"]])
                for r in group["ranks"]}) == 1


def _flat(tree, prefix=()):
    """{key path: tensor} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key, sub in tree.items()
            for k, v in _flat(sub, prefix + (key,)).items()}


def _to_jax(template, convert, tensors: dict):
    """`tensors` (in the port's names and layouts) as the reference's tree
    shaped as `template`: `convert` (models/importers.py, the reference
    → the port) of a tree of element indices says where each element of
    each port tensor comes from; every element is placed exactly once."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(template)
    sizes = [int(np.size(leaf)) for leaf in leaves]
    offsets = np.cumsum([0] + sizes)
    assert offsets[-1] < 2 ** 24  # indices exact in float32
    index = convert(jax.tree_util.tree_unflatten(treedef, [
        np.arange(o, o + n, dtype=np.float32).reshape(np.shape(leaf))
        for o, n, leaf in zip(offsets, sizes, leaves)]))
    flat = np.zeros(offsets[-1], np.float32)
    placed = np.zeros(offsets[-1], np.int64)
    values = _flat(tensors)
    for key, where in _flat(index).items():
        at = where.numpy().astype(np.int64).reshape(-1)
        flat[at] = values[key].detach().numpy().reshape(-1)
        placed[at] += 1
    assert (placed == 1).all()
    return jax.tree_util.tree_unflatten(treedef, [
        flat[o:o + n].reshape(np.shape(leaf))
        for o, n, leaf in zip(offsets, sizes, leaves)])


def _merge_bound(key, bundle, part, eps):
    """How far a merged parameter `key` may move when every trained
    element moves by at most `eps`: `eps` for a trained weight
    (`unfrozen`, the DreamBooth table), and for a LoRA target
    scale · r · eps · (max|A| + max|B| + eps), the product's terms
    (scale 1: alpha = rank); 0 for the rest."""
    module = key.rsplit(".", 1)[0]
    lora = bundle[f"{part}_lora"]
    bound = eps if key in bundle.get("unfrozen", {}) and part == "unet" \
        else 0.0
    if key.endswith(".weight") and module in lora:
        a, b = lora[module]["lora_A"], lora[module]["lora_B"]
        bound += a.shape[1] * eps * (a.abs().max().item()
                                     + b.abs().max().item() + eps)
    return bound


def test_cli_path_losses_and_merge_match_one_process(group):
    """The ranks' path against the same path in one process: the losses
    (1e-5 relative, the group's loss tolerance), the trained bundle
    gathered (each element within 1e-2 · lr, the group's bound on the
    trainables), and the merged UNet and CLIP gathered: a merged weight
    within that bound carried through the merge (`_merge_bound`), the
    DreamBooth table's trained row within it, every other parameter bit
    for bit."""
    from polyp_tpu_torch.train.sd_finetune import TOKEN_TABLE
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    one = group["refs"]["cli"]
    eps = 1e-2 * LR
    want_bundle = one["state"].whole_trainable()
    merged = {"unet": dict(one["merged"].unet.named_parameters()),
              "text": dict(one["merged"].text.named_parameters())}
    moved = 0.0
    for r in group["ranks"]:
        got = r["cli"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        assert list(got["bundle"]) == list(want_bundle)
        for g, w in zip(tree_leaves(got["bundle"]),
                        tree_leaves(want_bundle)):
            assert g.shape == w.shape
            assert (g - w.detach()).abs().max().item() <= eps
        for part in ("unet", "text"):
            have = got[f"merged_{part}"]
            assert set(have) == set(merged[part])
            for key, w in merged[part].items():
                w = w.detach()
                bound = (eps if key == TOKEN_TABLE else
                         _merge_bound(key, want_bundle, part, eps))
                if bound == 0.0:
                    assert torch.equal(have[key], w), key
                else:
                    err = (have[key] - w).abs().max().item()
                    assert err <= bound, (key, err, bound)
                    moved = max(moved, err)
    assert moved > 0  # the bound is not met by the same bits


def test_cli_path_merge_matches_the_references_merge(group):
    """Each rank's merged UNet and CLIP (its shard-wise merge, gathered)
    against polyp_tpu's merge of the same trained bundle (rank 0's,
    gathered) over the same fp32 weights: merge_lora over the `unfrozen`
    weights, embed_with_special_rows into the grown table, merge_lora of
    the text adapter (its cli/sd_common.py:326-345); 1e-6 of each
    kernel's scale, one fp32 product and sum (test_torch_port_lora's
    bound)."""
    import jax
    import jax.numpy as jnp

    from polyp_tpu.lora import surgery as jsurg
    from polyp_tpu.train import dreambooth as jdb
    from polyp_tpu_torch.models import importers as timp
    from polyp_tpu_torch.train.sd_finetune import TOKEN_TABLE
    from test_torch_port_lora import jax_tiny_stack

    one, payload = group["refs"]["cli"], group["payloads"]["cli"]
    bundle = group["ranks"][0]["cli"]["bundle"]
    _, up, _, _, _, tp = jax_tiny_stack()
    table = one["frozen"].text_params[TOKEN_TABLE]
    rows = table.shape[0] - 1
    key = jax.random.PRNGKey(0)
    tp = jdb.resize_token_embeddings(tp, rows + 1, key)
    lc, tc = (jsurg.LoRAConfig(c.rank, c.alpha, 0.0, c.target_modules)
              for c in (payload["lcfg"], payload["tcfg"]))
    base = {"unet": {n: p.detach() for n, p in
                     one["stack"].unet.named_parameters()},
            "text": {n: p.detach() for n, p in
                     one["stack"].text.named_parameters()}}
    base["text"][TOKEN_TABLE] = table
    junet = _to_jax(up, timp.unet_from_jax,
                    {**base["unet"], **bundle["unfrozen"]})
    jtext = jax.tree_util.tree_map(jnp.asarray, _to_jax(
        tp, timp.clip_text_from_jax, base["text"]))
    jtext = jdb.embed_with_special_rows(
        jtext, jnp.asarray(bundle["special_rows"].detach().numpy()),
        jnp.asarray([rows], jnp.int32))
    want = {
        "unet": timp.unet_from_jax(jax.tree_util.tree_map(
            np.asarray, jsurg.merge_lora(junet, _to_jax(
                jsurg.init_lora(up, lc, key), timp.lora_from_jax,
                bundle["unet_lora"]), lc))),
        "text": timp.clip_text_from_jax(jax.tree_util.tree_map(
            np.asarray, jsurg.merge_lora(jtext, _to_jax(
                jsurg.init_lora(tp, tc, key), timp.lora_from_jax,
                bundle["text_lora"]), tc)))}
    for r in group["ranks"]:
        for part in ("unet", "text"):
            got = r["cli"][f"merged_{part}"]
            assert set(got) == set(want[part])
            for name, w in want[part].items():
                scale = base[part][name].abs().max().item()
                np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                           rtol=0, atol=1e-6 * scale,
                                           err_msg=name)


@pytest.mark.parametrize("source", ["replay", "checkpoint"])
def test_cli_path_fp32_params_are_the_whole_tensors_slices(group, source):
    """`SDStack.fp32_params` of a stack sharded at load, from the seeded
    replay and from a diffusers checkpoint: on each rank, each split
    parameter's fp32 value is its model rank's slice of one process's
    fp32 tensor, bit for bit, and rounds to the rank's own bf16 shard."""
    from polyp_tpu_torch.cli.common import load_sd_stack

    payload = group["payloads"]["cli"]
    whole = (group["refs"]["cli"]["stack"] if source == "replay" else
             load_sd_stack(payload["ckpt"], dtype=torch.float32, tiny=True,
                           device="cpu"))
    for r in group["ranks"]:
        _, _, model_rank = r["mesh"]
        got = r["cli"]["fp32"][source]
        assert r["cli"]["fp32_rounds_to_the_shards"]
        for part, names in payload["fp32_names"].items():
            module = getattr(whole, part)
            plan = sharding.unet_param_sharding(module, K)
            assert set(got[part]) == set(names) and names
            for name in names:
                want = sharding.take(module.get_parameter(name).detach(),
                                     plan[name], model_rank, K)
                assert got[part][name].dtype == torch.float32
                assert torch.equal(got[part][name], want), (part, name)


@pytest.fixture(scope="module")
def cli_whole_sampler(group, tmp_path_factory):
    """One process's w8a8_static sampler over the tiny stack with the
    ranks' merged weights handed whole (gathered), and its images of the
    group's batch launched as the data ranks launch it. The sampler takes
    rank 0's prompt embeddings (from its sharded CLIP): at 16 px the
    mid-block's GroupNorms see two values a group, so the 3e-7 by which
    the sharded CLIP's rounding moves the embedding moves this trajectory
    by up to 13% of a table (a perturbation of 1e-6 by 0.4%); the
    embeddings are held to the whole CLIP's on their own."""
    from dataclasses import replace

    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.cli.sd_common import make_sampler
    from polyp_tpu_torch.lora.surgery import merged_module
    from polyp_tpu_torch.parallel.dryrun import launched_as_ranks

    got = group["ranks"][0]["cli"]
    stack = load_sd_stack(None, dtype=torch.float32, tiny=True,
                          device="cpu", seed=0)
    merged = replace(stack, unet=merged_module(stack.unet,
                                               got["merged_unet"]),
                     text=merged_module(stack.text, got["merged_text"]))
    with _quant_cache(tmp_path_factory.mktemp("cli_whole")):
        sampler = make_sampler(merged, group["payloads"]["cli"]["sampler"])
        embeddings = {p: sampler.encode_prompt(p) for p in (PROMPT, "")}
        sampler.register_prompt_embedding(PROMPT, got["cond"])
        sampler.register_prompt_embedding("", got["uncond"])
        images = launched_as_ranks(sampler, got["cond"], _fan_init(4, 3), 2)
    return sampler, images, embeddings


def test_cli_path_images_match_the_whole_merged_weights(group,
                                                        cli_whole_sampler):
    """The group's batch against the whole merged weights' (fan-out
    bounds), and each rank's prompt embeddings from its sharded merged
    CLIP against the whole one's (1e-5 relative L2)."""
    _, want, embeddings = cli_whole_sampler
    top = want.abs().max().item()
    for r in group["ranks"]:
        assert r["cli"]["images"].shape == (4, 3, 16, 16)
        _assert_images_close(r["cli"]["images"], want, top)
        for key, prompt in (("cond", PROMPT), ("uncond", "")):
            w = embeddings[prompt]
            assert (r["cli"][key] - w).norm() <= 1e-5 * w.norm()


def test_cli_path_calibration_key_and_tables_match_one_device(
        group, cli_whole_sampler):
    """Every rank's cache key is one process's key of the same whole
    weights; its tables are one device's (1e-6, as the sampler's tables
    above), and the same bit for bit when one rank of each model group
    misses its cache and the other hits."""
    sampler, _, _ = cli_whole_sampler
    want = sampler.quant_scales
    assert len(want) > 0
    for r in group["ranks"]:
        got = r["cli"]
        assert got["key"] == sampler.calibration_key
        assert set(got["tables"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["tables"][k], w, rtol=1e-6,
                                       err_msg=k)
        assert got["tables_after_one_miss"] == got["tables"]


# ---------------------------------------------------------------------------
# the rules, in this process
# ---------------------------------------------------------------------------

def _reference_specs(params, jfn):
    """{'/'-joined reference path: PartitionSpec} of polyp_tpu's rules
    over a 2 × 2 mesh."""
    import jax

    from polyp_tpu.parallel import make_mesh

    mesh = make_mesh({"data": 2, "model": K}, jax.devices()[:WORLD])
    tree = jfn(params, mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(k.key for k in path): leaf.spec for path, leaf in flat}


def _torch_spec(split, ndim):
    """The reference's PartitionSpec of a port Split on a torch tensor of
    `ndim` dims ([out, in] weights; kernels are [in, out] there)."""
    from jax.sharding import PartitionSpec as P
    if split is None:
        return P()
    if ndim == 1:
        return P("model")
    return P(None, "model") if split.dim == 0 else P("model", None)


@pytest.mark.parametrize("part", ["unet", "text"])
def test_rules_match_the_references_partition_specs(part):
    from polyp_tpu.parallel import unet_param_sharding as junet_sharding
    from polyp_tpu_torch.models import importers as timp
    from test_torch_port_lora import jax_tiny_stack, port_tiny_stack

    _, up, _, _, _, tp = jax_tiny_stack()
    module = getattr(port_tiny_stack(), part)
    want = _reference_specs(up if part == "unet" else tp, junet_sharding)
    plan = sharding.unet_param_sharding(module, K)
    split = 0
    for name, p in module.named_parameters():
        layer, leaf = name.rsplit(".", 1)
        ref_leaf = {"weight": "kernel"}.get(leaf, leaf)
        path = f"{timp.jax_module_path(layer)}/{ref_leaf}"
        if path not in want:  # norms' and embeddings' names differ
            assert plan[name] is None, name
            continue
        assert _torch_spec(plan[name], p.ndim) == want[path], name
        split += plan[name] is not None
    assert split > 0


def test_lora_rules_match_the_references():
    import jax

    from polyp_tpu.lora import surgery as jsurg
    from polyp_tpu.parallel import lora_param_sharding as jlora_sharding
    from polyp_tpu_torch.configs import LORA_MODULE_PRESETS
    from polyp_tpu_torch.lora import surgery as tsurg
    from test_torch_port_lora import jax_tiny_stack, port_tiny_stack

    from jax.sharding import PartitionSpec as P

    _, up, _, _, _, _ = jax_tiny_stack()
    targets = LORA_MODULE_PRESETS["attention_mlp"]
    jadapter = jsurg.init_lora(up, jsurg.LoRAConfig(4, None, 0.0, targets),
                               jax.random.PRNGKey(0))
    want = _reference_specs(jadapter, jlora_sharding)
    unet = port_tiny_stack().unet
    adapter = tsurg.init_lora(unet, tsurg.LoRAConfig(4, None, 0.0, targets),
                              torch.Generator().manual_seed(0))
    plan = sharding.lora_param_sharding(adapter, unet, K)
    from polyp_tpu_torch.models import importers as timp
    for layer, factors in plan.items():
        for leaf, split in factors.items():
            spec = want[f"{timp.jax_module_path(layer)}/{leaf}"]
            if isinstance(split, sharding.Split):
                assert spec == (P("model", None) if split.dim == 0
                                else P(None, "model")), (layer, leaf)
            else:
                assert spec == P(), (layer, leaf)


def test_blocks_kept_whole_where_k_does_not_divide():
    """At k = 4 the tiny stack's 2-head attentions stay whole while its
    FFs (hidden 128) split; at k = 8 SD-v1-4's 8-head UNet attentions
    split while CLIP's 12 heads stay whole (checked on meta modules)."""
    from polyp_tpu_torch.cli.common import build_modules
    from test_torch_port_lora import port_tiny_stack

    unet = port_tiny_stack().unet
    blocks = sharding.tp_blocks(unet, 4)
    assert blocks and not any(v for k, v in blocks.items()
                              if k.endswith(("attn1", "attn2")))
    assert all(v for k, v in blocks.items() if k.endswith(".ff"))
    plan = sharding.unet_param_sharding(unet, 4)
    assert all(v is None for k, v in plan.items() if ".attn" in k)
    sd_unet, _, sd_text = build_modules(False, torch.bfloat16, "meta")
    assert all(sharding.tp_blocks(sd_unet, 8).values())
    text = sharding.tp_blocks(sd_text, 8)
    assert not any(v for k, v in text.items() if k.endswith("self_attn"))
    assert all(v for k, v in text.items() if k.endswith("mlp"))


def test_geglu_per_half_split_sums_to_the_whole_ff():
    """Each rank's FF on its [a_m; gate_m] rows and H/k columns of W2 with
    a zero b2, summed and then given b2, is the whole FF; one contiguous
    block of the [a; gate] stack is not."""
    from polyp_tpu_torch.models.unet_blocks import FeedForward
    from polyp_tpu_torch.ops.fused_geglu import reference_geglu

    block = torch.nn.Module()  # the reference names it by its `ff` key
    block.ff = ff = FeedForward(32)
    torch.manual_seed(0)
    for p in ff.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.randn(2, 5, 32)
    proj, out = ff.net[0].proj, ff.net[2]
    plan = sharding.unet_param_sharding(block, K)
    assert plan["ff.net.0.proj.weight"] == sharding.Split(0, 2)
    assert plan["ff.net.2.weight"] == sharding.Split(1)

    def parts(split_w1):
        total = 0
        for m in range(K):
            w1 = sharding.take(proj.weight, split_w1, m, K)
            b1 = sharding.take(proj.bias, split_w1, m, K)
            w2 = sharding.take(out.weight, sharding.Split(1), m, K)
            total = total + reference_geglu(x, w1, b1, w2,
                                            torch.zeros_like(out.bias))
        return total + out.bias

    with torch.no_grad():
        want = ff(x)
        np.testing.assert_allclose(parts(plan["ff.net.0.proj.weight"]), want,
                                   rtol=1e-5, atol=1e-6)
        wrong = parts(sharding.Split(0))
    assert (wrong - want).abs().max() > 0.1


@pytest.mark.parametrize("split", [sharding.Split(0), sharding.Split(1),
                                   sharding.Split(0, 2), sharding.Split(1, 2),
                                   None])
@pytest.mark.parametrize("k", [2, 4])
def test_shard_then_assemble_is_the_identity(split, k):
    t = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    shards = [sharding.take(t, split, m, k) for m in range(k)]
    assert torch.equal(sharding.assemble(shards, split), t)
    if split is not None:
        assert all(s.shape[split.dim] == t.shape[split.dim] // k
                   for s in shards)
