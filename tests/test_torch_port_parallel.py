"""The port's data-parallel group (polyp_tpu_torch/parallel/) against
polyp_tpu's device mesh on the CPU.

* `mesh_from_spec`'s grammar and its errors, against polyp_tpu's on the
  conftest's fake CPU devices: the `data × model` shape of the reference's
  mesh, its rank layout (rank = d·model + m), and the port's own refusal
  of `data × model` other than the world size.
* The Loader's row sharding and per-process striding: the reference's two
  cases (tests/test_parallel_wiring.py's cross-process mesh and
  no-mesh-striding tests).
* One 2-rank gloo group (spawned once for the module) runs the tiny LoRA
  step, the scratch DDPM step and the classifier step (class weights;
  its eval step with a `valid` mask that differs between the ranks) on
  its rows, against polyp_tpu's steps jitted over make_mesh({"data": 2}):
  the port's ranks take the reference's draws for the global batch (made
  in this process and recorded through the port's one-process step), so
  both compute the same function; and the quota fan-out (for_prompt and
  generate_to_dir) against the one-process sampler.
* UNet2D's dropout against the reference's: masks recorded from its
  forward (jax.random.bernoulli patched), handed to the port's.

Tolerances: losses 1e-5 relative; parameters after two updates within
1e-2 · lr of the reference's (one Adam update at lr > 0: Adam divides each
gradient by its own RMS, so a relative gradient difference ε moves an
element by ε · lr), as tests/test_torch_port_train.py holds the
one-process steps (the classifier's after one update, where its gradient
is not float noise, explained at its test); BatchNorm running statistics
1e-5 relative L2; the
trained parameters bit-equal across the ranks; fan-out images 1e-6
against one process launching the ranks' rows (explained at its test);
dropout forwards 1e-5 relative L2.

The spawned ranks import this module: its top level imports no JAX (the
reference and the test helpers that import it are imported inside the
tests).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch

from polyp_tpu_torch.data import pipeline as tpipe
from polyp_tpu_torch.parallel import launch, mesh as pmesh

WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (and its spawned ranks, which
    split this process's threads): the tiny models' many small CPU ops
    each open an OpenMP region, which waits for cores when the suite's
    parallel workers each run a thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _key(name, args):
    return (name, *[tuple(a) if isinstance(a, (tuple, list, torch.Size))
                    else a for a in args])


class Recorder:
    """Calls through to a draws object and keeps each result by (method,
    arguments)."""

    def __init__(self, draws):
        self.draws, self.calls = draws, {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        fn = getattr(self.draws, name)

        def call(*args):
            out = self.calls[_key(name, args)] = fn(*args)
            return out
        return call


class Replay:
    """The recorded draws, by (method, arguments): a rank's RankDraws asks
    for the global batch's draws, which the one-process step recorded."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *args: self.calls[_key(name, args)]


# ---------------------------------------------------------------------------
# the ranks' work (one spawned group for the module)
# ---------------------------------------------------------------------------

def _lora(mesh, p):
    from polyp_tpu_torch.train import sd_finetune as tsf
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    state = tsf.create_sd_train_state(p["cfg"], p["bundle"])
    losses = []
    for images, calls in zip(p["images"], p["draws"]):
        state, loss = tsf.sd_lora_train_step(
            state, p["frozen"], p["schedule"], mesh.local(images), p["ids"],
            None, Replay(calls), p["lcfg"], None, 1.0, 0.1, mesh=mesh)
        losses.append(loss.item())
    return {"losses": losses,
            "trainable": [t.detach() for t in tree_leaves(state.trainable)],
            "checksum": pmesh.checksum(state.trainable)}


def _scratch(mesh, p):
    from polyp_tpu_torch.train import scratch_ddpm as tddpm

    state = tddpm.create_ddpm_state(p["cfg"], p["model"], torch.Generator())
    with torch.no_grad():
        for k, v in state.params.items():
            v.copy_(p["params"][k])
    losses = []
    for calls in p["draws"]:
        state, loss = tddpm.ddpm_train_step(
            state, p["schedule"], mesh.local(p["images"]), Replay(calls),
            mesh=mesh)
        losses.append(loss.item())
    return {"losses": losses,
            "params": {k: v.detach() for k, v in state.params.items()},
            "checksum": pmesh.checksum(state.params)}


def _classifier(mesh, p):
    from polyp_tpu_torch.train import classifier as tc

    state = tc.create_classifier_state(p["cfg"], 3, "cpu").on_mesh(mesh)
    state.model.load_state_dict(p["state_dict"])
    images, labels, valid = p["eval"]
    eloss, _, ecorrect = tc.eval_step(state, mesh.local(images),
                                      mesh.local(labels), mesh.local(valid),
                                      p["cw"])
    losses, correct, states = [], [], []
    for images, labels, draws in p["steps"]:
        loss, c = tc.train_step(state, mesh.local(images),
                                mesh.local(labels), draws, p["cw"])
        losses.append(loss.item())
        correct.append(int(c))
        states.append({
            "state": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "mu": {k: state.optimizer.state[v]["mu"].clone()
                   for k, v in state.model.named_parameters()}})
    return {"losses": losses, "correct": correct, "states": states,
            "eval": (eloss.item(), int(ecorrect)),
            "checksum": pmesh.checksum(state.model)}


def _fan_out(mesh, p):
    from polyp_tpu_torch.pipeline import generate_to_dir

    sampler = _tiny_sampler(p["stack"], mesh)
    fn = sampler.for_prompt("a colon polyp")
    images = fn(p["batch"], 3)
    written = generate_to_dir(fn, p["n_files"], p["out_dir"], p["batch"],
                              seed=5, mesh=mesh)
    return {"images": images, "written": written}


def _group(mesh, payloads):
    return {name: fn(mesh, payloads[name]) for name, fn in (
        ("lora", _lora), ("scratch", _scratch), ("classifier", _classifier),
        ("fan_out", _fan_out))}


def _tiny_sampler(stack, mesh=None):
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.pipeline import StableDiffusionSampler

    return StableDiffusionSampler(
        stack.unet, stack.vae, stack.text, stack.tokenizer,
        DiffusionSchedule.create(50, "scaled_linear", 0.00085, 0.012),
        image_size=16, num_steps=3, guidance_scale=7.5, sampler="unipc",
        mesh=mesh)


# ---------------------------------------------------------------------------
# the references (this process)
# ---------------------------------------------------------------------------

def _lora_case():
    """The group's payload (the port's draws recorded through its
    one-process step), and a function computing the reference's steps."""
    import jax
    import jax.numpy as jnp

    from polyp_tpu.diffusion import DiffusionSchedule as JSchedule
    from polyp_tpu.parallel import make_mesh, replicate_to, shard_batch
    from polyp_tpu.train import sd_finetune as jsf
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.train import sd_finetune as tsf
    from test_torch_port_train import SD, JaxDraws, _jax_tree, _setup

    s = _setup({"dropout": 0.1})
    tschedule = DiffusionSchedule.create(**SD)
    rng = np.random.default_rng(54)
    images = [rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
              for _ in range(2)]
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    one = tsf.create_sd_train_state(s["tcfg"], s["bundle"])
    ids = torch.from_numpy(s["ids"]).long()
    draws = []
    for key, batch in zip(keys, images):
        rec = Recorder(JaxDraws(key))
        tsf.sd_lora_train_step(one, s["tfrozen"], tschedule,
                               torch.from_numpy(batch), ids, None, rec,
                               s["tlc"], None, 1.0, 0.1)
        draws.append(rec.calls)
    payload = dict(cfg=s["tcfg"], bundle=s["bundle"], frozen=s["tfrozen"],
                   schedule=tschedule, ids=ids, lcfg=s["tlc"],
                   images=[torch.from_numpy(b) for b in images], draws=draws)

    def reference():
        mesh = make_mesh({"data": WORLD}, jax.devices()[:WORLD])
        jstate, jlosses = replicate_to(s["jstate"], mesh), []
        for key, batch in zip(keys, images):
            jstate, jloss = jsf.sd_lora_train_step(
                jstate, s["jfrozen"], JSchedule.create(**SD),
                shard_batch(jnp.asarray(batch), mesh),
                jnp.asarray(s["ids"]), jnp.zeros(1, jnp.int32), key,
                s["lc"], None, 1.0, 0.1)
            jlosses.append(float(jloss))
        return {"losses": jlosses, "bundle": s["bundle"],
                "after": _jax_tree(jstate.trainable)}

    return payload, reference


def _scratch_case():
    import jax
    import jax.numpy as jnp

    from polyp_tpu.diffusion import schedule as jsched
    from polyp_tpu.parallel import make_mesh, replicate_to, shard_batch
    from polyp_tpu.train import scratch_ddpm as jddpm
    from polyp_tpu_torch.diffusion import schedule as tsched
    from polyp_tpu_torch.models import importers as timp
    from polyp_tpu_torch.train import scratch_ddpm as tddpm
    from test_torch_port_scratch import JaxDraws, _images, _states

    _, jstate, tcfg, tstate = _states(1, 2)
    images = _images(4)
    tschedule = tsched.DiffusionSchedule.create(1000)
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    keys = [jax.random.PRNGKey(200 + i) for i in range(2)]
    draws = []
    for key in keys:
        rec = Recorder(JaxDraws(key))
        tstate, _ = tddpm.ddpm_train_step(tstate, tschedule,
                                          torch.from_numpy(images), rec)
        draws.append(rec.calls)
    payload = dict(cfg=tcfg, model=tstate.model, params=before,
                   schedule=tschedule, images=torch.from_numpy(images),
                   draws=draws)

    def reference():
        mesh = make_mesh({"data": WORLD}, jax.devices()[:WORLD])
        js, jlosses = replicate_to(jstate, mesh), []
        for key in keys:
            js, jloss = jddpm.ddpm_train_step(
                js, jsched.DiffusionSchedule.create(1000),
                shard_batch(jnp.asarray(images), mesh), key)
            jlosses.append(float(jloss))
        after = timp.unet2d_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            js.params))
        return {"losses": jlosses, "before": before, "after": after}

    return payload, reference


def _classifier_draws(jmodel, variables, shape, key, model):
    """The reference's draws of a train step with key `key`, as
    tests/test_torch_port_classifier.py::jax_draws records them (the flip
    of fold_in(key, 0); the stochastic-depth and dropout masks its forward
    draws from fold_in(key, 1), in call order), from a jitted forward whose
    only outputs are the masks (so its compile drops the forward)."""
    import jax
    import jax.numpy as jnp

    from polyp_tpu_torch.train import classifier as tc

    bernoulli = jax.random.bernoulli

    def masks(variables, key):
        recorded = []

        def record(*args, **kwargs):
            recorded.append(bernoulli(*args, **kwargs))
            return recorded[-1]

        with mock.patch.object(jax.random, "bernoulli", record):
            jmodel.apply(variables, jnp.zeros(shape, jnp.float32),
                         train=True, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.fold_in(key, 1)})
        return recorded

    recorded = [np.array(m) for m in jax.jit(masks)(variables, key)]
    flip = np.array(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                         (shape[0],)))
    names = [b.block_name for b in model.backbone.blocks() if b.draws_rows]
    assert len(recorded) == len(names) + 1
    return tc.ClassifierDraws(
        torch.from_numpy(flip),
        {k: torch.from_numpy(r.reshape(-1)) for k, r in zip(names, recorded)},
        torch.from_numpy(recorded[-1]))


def _classifier_case():
    import functools

    import jax
    import jax.numpy as jnp

    from polyp_tpu.models.efficientnet import PolypClassifier as JClassifier
    from polyp_tpu.parallel import make_mesh, replicate_to, shard_batch
    from polyp_tpu.train import classifier as jtc
    from polyp_tpu_torch.models.importers import efficientnet_from_jax
    from polyp_tpu_torch.train import classifier as tc
    from test_torch_port_classifier import BATCH, SIZE, _configs, nudge
    from test_torch_port_lora import _init_like

    jcfg, cfg = _configs()
    # the reference's state over seeded values of its init's shapes
    # (an eager flax init costs seconds), BatchNorm scales, biases and
    # statistics nudged off their init so that they matter
    jmodel = JClassifier(3, cfg.hidden_features, cfg.dropout, cfg.variant)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, SIZE, SIZE, 3)))
    params = nudge(_init_like(shapes["params"], 2), 2)
    stats = nudge(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes["batch_stats"]), 3)
    tx = jtc.make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtc.ClassifierState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(jparams), tx=tx, apply_fn=jmodel.apply)
    state = tc.create_classifier_state(cfg, 3, "cpu")
    state.model.load_state_dict(efficientnet_from_jax(params, stats))
    rng = np.random.default_rng(1)
    cw = np.array([0.5, 2.0, 1.0], np.float32)
    evaluation = (
        rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
        rng.integers(0, 3, BATCH).astype(np.int32),
        np.array([1, 1, 1, 0, 1, 0, 0, 0], bool))  # 3 valid rows, then 1
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    # the classes fall unevenly over the ranks' halves
    labels = np.array([0, 0, 0, 1, 2, 2, 1, 2], np.int32)
    key = jax.random.PRNGKey(10)
    draws = _classifier_draws(jmodel, {"params": jparams,
                                       "batch_stats": jstate.batch_stats},
                              images.shape, key, state.model)
    payload = dict(cfg=cfg, state_dict=state.model.state_dict(),
                   cw=torch.from_numpy(cw),
                   steps=[(torch.from_numpy(images),
                           torch.from_numpy(labels), draws)],
                   eval=tuple(torch.from_numpy(a) for a in evaluation))

    def reference():
        mesh = make_mesh({"data": WORLD}, jax.devices()[:WORLD])
        js = replicate_to(jstate, mesh)
        eloss, _, ecorrect = jtc.eval_step(
            js, *(shard_batch(jnp.asarray(a), mesh) for a in evaluation),
            jnp.asarray(cw), mp="fp32")
        js, jloss, jc = jtc.train_step(
            js, shard_batch(jnp.asarray(images), mesh),
            shard_batch(jnp.asarray(labels), mesh), key, jnp.asarray(cw),
            mp="fp32")
        return {"losses": [float(jloss)], "correct": [int(jc)],
                "eval": (float(eloss), int(ecorrect)), "jstates": [js]}

    return payload, reference


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case's references, and the 2-rank group's results (the group
    spawned once)."""
    from polyp_tpu_torch.cli.common import load_sd_stack

    out_dir = tmp_path_factory.mktemp("fan_out")
    stack = load_sd_stack(tiny=True, dtype=torch.float32, device="cpu")
    cases = {"lora": _lora_case(), "scratch": _scratch_case(),
             "classifier": _classifier_case()}
    payloads = {k: v[0] for k, v in cases.items()}
    payloads["fan_out"] = dict(stack=stack, batch=4, n_files=6,
                               out_dir=str(out_dir / "group"))
    # the ranks run while this process compiles the reference's steps
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn_group, _group, WORLD, (payloads,),
                            timeout=300)
        refs = {k: v[1]() for k, v in cases.items()}
        return {"refs": refs, "ranks": ranks.result(), "stack": stack,
                "out_dir": out_dir}


# ---------------------------------------------------------------------------
# the mesh spec and the Loader
# ---------------------------------------------------------------------------

GOOD_SPECS = [("data=8", 8), ("data=-1", 8), ("data=-1", 2), ("data=2", 2),
              ("data=-1,model=1", 4), ("data=1", 1)]
BAD_SPECS = ["data", "data=x", "=4", "data=0", "data=-2",
             "data=-1,model=-1", "data=-1,model=3"]
# data × model other than the world of 8: the reference takes the first
# N devices of a larger world (and refuses more than it has); the port,
# one process a rank, refuses both
WRONG_WORLD = ["data=4,model=4", "data=3,model=2", "model=4", "data=2,model=2"]


@pytest.mark.parametrize("spec,world", GOOD_SPECS)
def test_mesh_spec_gives_the_references_data_axis(spec, world):
    import jax

    from polyp_tpu.parallel import mesh_from_spec as jspec

    want = jspec(spec, jax.devices()[:world])
    got = pmesh.mesh_from_spec(spec, world_size=world)
    assert got.shape == {"data": want.shape["data"]} == {"data": world}
    assert pmesh.mesh_from_spec(None) is None
    assert pmesh.mesh_from_spec("") is None and jspec("") is None


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_mesh_spec_errors_are_the_references(spec):
    import jax

    from polyp_tpu.parallel import mesh_from_spec as jspec

    with pytest.raises(ValueError) as want:
        jspec(spec, jax.devices())
    with pytest.raises(ValueError) as got:
        pmesh.mesh_from_spec(spec, world_size=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["data=4,model=2", "model=8",
                                  "data=-1,model=2"])
def test_a_model_axis_gives_the_references_mesh_shape(spec):
    """At a world of 8 the port's mesh has the reference's (data, model)
    axis sizes, and its ranks the reference's device order: make_mesh
    reshapes the devices row-major over (data, model), so rank r holds
    the device at [r // model, r % model]."""
    import jax

    from polyp_tpu.parallel import mesh_from_spec as jspec

    want = jspec(spec, jax.devices()[:8])
    got = pmesh.mesh_from_spec(spec, world_size=8)
    n, k = want.shape.get("data", 1), want.shape.get("model", 1)
    assert (got.size, got.model_size) == (n, k)
    devices = np.asarray(want.devices).reshape(n, k)
    ids = {d.id: i for i, d in enumerate(jax.devices()[:8])}
    for d in range(n):
        row = pmesh.DataMesh(n, d, model_size=k, model_rank=0)
        assert row.model_ranks() == [ids[dev.id] for dev in devices[d]]
    for m in range(k):
        col = pmesh.DataMesh(n, 0, model_size=k, model_rank=m)
        assert col.data_ranks() == [ids[dev.id] for dev in devices[:, m]]


def test_mesh_from_spec_lays_ranks_out_as_the_reference():
    got = pmesh.mesh_from_spec("data=2,model=2", world_size=4)
    assert got.shape == {"data": 2, "model": 2}
    assert (got.rank, got.model_rank, got.world_rank) == (0, 0, 0)
    for r in range(4):
        mesh = pmesh.DataMesh(2, r // 2, model_size=2, model_rank=r % 2)
        assert mesh.world_rank == r
        assert mesh.model_ranks() == [r // 2 * 2, r // 2 * 2 + 1]
        assert mesh.data_ranks() == [r % 2, 2 + r % 2]


@pytest.mark.parametrize("spec", WRONG_WORLD)
def test_data_times_model_must_equal_the_world(spec):
    with pytest.raises(ValueError, match="got a world of 8"):
        pmesh.mesh_from_spec(spec, world_size=8)


def test_data_must_equal_the_world_size():
    with pytest.raises(ValueError, match="needs 4 ranks, got a world of 8"):
        pmesh.mesh_from_spec("data=4", world_size=8)
    with pytest.raises(ValueError, match="batch_size=6 not divisible"):
        pmesh.validate_batch_for_mesh(6, pmesh.DataMesh(4))


def test_cli_mesh_flag_outside_a_launch(monkeypatch):
    """--mesh as the CLIs parse it, without torchrun: WORLD_SIZE unset is
    a world of one (no group started), where a model axis of 2 needs two
    ranks."""
    import argparse

    from polyp_tpu_torch.cli.common import add_common_flags, get_mesh_from

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    args = parser.parse_args(["--device", "cpu", "--mesh", "data=-1"])
    assert get_mesh_from(args) == pmesh.DataMesh(1)
    assert not torch.distributed.is_initialized() and args.device == "cpu"
    assert get_mesh_from(parser.parse_args(["--device", "cpu"])) is None
    with pytest.raises(ValueError, match="needs 2 ranks, got a world of 1"):
        get_mesh_from(parser.parse_args(["--device", "cpu", "--mesh",
                                         "data=1,model=2"]))


def _loaders(mesh, jmesh):
    from polyp_tpu.data.pipeline import Loader as JLoader

    images = np.arange(32 * 2 * 2 * 3, dtype=np.uint8).reshape(32, 2, 2, 3)
    labels = np.arange(32, dtype=np.int64) % 3
    return (JLoader(images, labels, 8, shuffle=False, mesh=jmesh,
                    process_shard=True),
            tpipe.Loader(images, labels, 8, shuffle=False, mesh=mesh,
                         process_shard=True, device="cpu"))


@pytest.mark.parametrize("rank", [0, 1])
def test_loader_rows_under_a_group_are_the_references_shards(monkeypatch,
                                                             rank):
    """The reference's cross-process mesh: no striding, every global batch
    on every host, each contributing its shards; the port's rank yields
    its rows of each global batch."""
    import jax

    from polyp_tpu.data.pipeline import Loader as JLoader
    from polyp_tpu.parallel import make_mesh

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(JLoader, "_mesh_spans_processes", lambda self: True)
    monkeypatch.setattr(pmesh, "process_count", lambda: 2)
    monkeypatch.setattr(pmesh, "process_index", lambda: rank)
    jl, tl = _loaders(pmesh.DataMesh(2, rank), make_mesh({"data": 8}))
    assert len(tl) == len(jl) == 4
    want = list(jl._host_batches())
    got = list(tl.host_batches())
    assert len(got) == len(want) == 4
    rows = slice(4 * rank, 4 * rank + 4)
    for (gi, gl, gv), (wi, wl, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi[rows])
        np.testing.assert_array_equal(gl, wl[rows])
        np.testing.assert_array_equal(gv, wv[rows])
    np.testing.assert_array_equal(got[0][1], (np.arange(8) % 3)[rows])


def test_loader_without_a_group_keeps_per_process_striding(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(pmesh, "process_count", lambda: 2)
    monkeypatch.setattr(pmesh, "process_index", lambda: 1)
    jl, tl = _loaders(None, None)
    assert len(tl) == len(jl) == 2  # 4 batches / 2 processes
    got, want = list(tl.host_batches()), list(jl._host_batches())
    assert len(got) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    # process 1 takes the strided slice [1::2]: batches 1 and 3
    np.testing.assert_array_equal(got[0][1], np.arange(8, 16) % 3)


def test_loader_tail_batch_rows_and_valid_mask():
    """A padded tail batch: each rank's rows and its part of the mask."""
    images = np.zeros((10, 1, 1, 3), np.uint8)
    labels = np.arange(10)
    got = [list(tpipe.Loader(images, labels, 8, shuffle=False, device="cpu",
                             mesh=pmesh.DataMesh(2, r)).host_batches())
           for r in (0, 1)]
    assert [b[2].tolist() for b in got[0]] == [[True] * 4, [True] * 2
                                               + [False] * 2]
    assert [b[2].tolist() for b in got[1]] == [[True] * 4, [False] * 4]
    np.testing.assert_array_equal(got[1][0][1], [4, 5, 6, 7])


def test_shard_batch_takes_this_ranks_rows():
    x, y = np.arange(16).reshape(8, 2), torch.arange(8)
    mesh = pmesh.DataMesh(2, 1)
    gx, gy = pmesh.shard_batch((x, y), mesh)
    np.testing.assert_array_equal(gx, x[4:])
    assert torch.equal(gy, y[4:])
    assert torch.equal(pmesh.shard_batch({"y": y}, mesh)["y"], y[4:])
    assert pmesh.shard_batch((x, y), None) == (x, y)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_batch(torch.arange(5), mesh)


def test_checksum_sees_every_bit_and_position():
    t = {"a": torch.randn(3, 4), "b": torch.randn(5).bfloat16(),
         "c": torch.arange(7)}
    base = pmesh.checksum(t)
    assert pmesh.checksum({k: v.clone() for k, v in t.items()}) == base
    flipped = t["a"].clone()
    flipped.view(torch.int32)[1, 2] ^= 1  # the lowest mantissa bit
    assert pmesh.checksum({**t, "a": flipped}) != base
    assert pmesh.checksum({**t, "c": t["c"].flip(0)}) != base
    assert pmesh.replicated(t, None) and pmesh.replicated(t, pmesh.DataMesh(1))


# ---------------------------------------------------------------------------
# the group's steps against the reference's mesh steps
# ---------------------------------------------------------------------------

LR = 1e-3  # the train and scratch tests' learning rate


def test_ranks_hold_the_same_trained_bits(group):
    for name in ("lora", "scratch", "classifier"):
        sums = {r[name]["checksum"] for r in group["ranks"]}
        assert len(sums) == 1, name


def test_dp_lora_step_matches_the_references_mesh_step(group):
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    ref = group["refs"]["lora"]
    got = group["ranks"][0]["lora"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    before, after = tree_leaves(ref["bundle"]), tree_leaves(
        {k: ref["after"][k] for k in ref["bundle"]})
    assert len(got["trainable"]) == len(after)
    moved = max((w - b).abs().max().item() for w, b in zip(after, before))
    assert moved > 0.5 * LR
    for g, w, b in zip(got["trainable"], after, before):
        assert ((g - b) - (w - b)).abs().max().item() <= 1e-2 * LR


def test_dp_scratch_step_matches_the_references_mesh_step(group):
    ref = group["refs"]["scratch"]
    got = group["ranks"][0]["scratch"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for k, w in ref["after"].items():
        b = ref["before"][k]
        assert (w - b).abs().max().item() > 0.5 * LR, k
        err = ((got["params"][k] - b) - (w - b)).abs().max().item()
        assert err <= 1e-2 * LR, (k, err)


def test_dp_classifier_step_matches_the_references_mesh_step(group):
    """Class weights over classes that fall unevenly on the ranks (the
    global Σw·nll / Σw) and BatchNorm statistics over the global batch:
    the step's loss, count and update; the eval step's loss and count with
    a `valid` mask of 3 rows on one rank and 1 on the other."""
    import jax

    from polyp_tpu_torch.models.importers import efficientnet_from_jax
    from test_torch_port_classifier import rel_l2

    ref = group["refs"]["classifier"]
    got = group["ranks"][0]["classifier"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert got["correct"] == ref["correct"]
    # the update: its gradients (Adam's first moment, 0.1 · the gradient)
    # within 1e-4 of each tensor's largest, the statistics 1e-5 relative,
    # and the parameters within 1e-2 · lr where the gradient is at least
    # 1e-3 of its tensor's largest: below that (the project.bn.bias
    # gradients, ~1e-8, which the next BatchNorm all but cancels, and
    # elements near 0) Adam turns float noise into ±lr moves whose signs
    # follow the summation order, which the group changes
    jstate = ref["jstates"][0]
    want_mu = efficientnet_from_jax(jax.device_get(
        jstate.opt_state[1][0].mu))
    want = efficientnet_from_jax(jax.device_get(jstate.params),
                                 jax.device_get(jstate.batch_stats))
    first = got["states"][0]
    for k, w in want_mu.items():
        if k.endswith("project.bn.bias"):
            continue
        g, scale = first["mu"][k], w.abs().max()
        assert (g - w).abs().max() <= 1e-4 * scale, k
        signal = w.abs() >= 1e-3 * scale
        err = (first["state"][k] - want[k]).abs()[signal]
        assert err.max() <= 1e-2 * LR, k
    for k, w in want.items():
        if "running" in k:
            assert rel_l2(first["state"][k], w) <= 1e-5, k
    np.testing.assert_allclose(got["eval"][0], ref["eval"][0], rtol=1e-5)
    assert got["eval"][1] == ref["eval"][1]


def _rank_launches(sampler, batch: int, seed: int) -> torch.Tensor:
    """One process's images of a fan-out batch launched as the ranks
    launch it: the whole batch's latents from the batch's seed, padded to
    a multiple of the group, each rank's rows one launch."""
    from polyp_tpu_torch.diffusion.samplers import _gaussian
    from polyp_tpu_torch.ops.conv import slot_invariant_region
    from polyp_tpu_torch.pipeline import _pad_rows

    cond, uncond = sampler.encode_prompt("a colon polyp"), \
        sampler.encode_prompt("")
    init = _gaussian((batch, 4, 2, 2),
                     torch.Generator().manual_seed(seed), "fan-out")
    init = _pad_rows(init, pmesh.padded_batch(batch, pmesh.DataMesh(WORLD)))
    per = init.shape[0] // WORLD
    with slot_invariant_region(), torch.no_grad():
        rows = [sampler.generate(cond, uncond, per, None,
                                 init[r * per:(r + 1) * per])
                for r in range(WORLD)]
    return torch.cat(rows)[:batch]


def test_fan_out_matches_the_one_process_sampler(group):
    """The group's images (on every rank) and files (written by rank 0:
    the 1-based names one process writes) against one process launching
    each rank's rows. Against one launch of the whole batch the tiny
    random UNet's guided trajectory amplifies the convolutions'
    batch-size rounding (~1e-5 in one forward) to ~0.2, so the reference
    launches at the ranks' size, where the group must agree to rounding."""
    from PIL import Image

    from polyp_tpu_torch.pipeline import images_uint8

    sampler = _tiny_sampler(group["stack"])
    want = _rank_launches(sampler, 4, 3)
    for r in group["ranks"]:
        got = r["fan_out"]["images"]
        assert got.shape == want.shape == (4, 3, 16, 16)
        assert (got - want).abs().max().item() <= 1e-6
        assert r["fan_out"]["written"] == 6
    files = group["out_dir"] / "group"
    assert sorted(p.name for p in files.iterdir()) == sorted(
        f"{i}.png" for i in range(1, 7))
    # generate_to_dir's batches: seed 5 (4 images), seed 6 (2 images)
    want = images_uint8(torch.cat([_rank_launches(sampler, 4, 5),
                                   _rank_launches(sampler, 2, 6)])).numpy()
    for i, img in enumerate(want):
        got = np.asarray(Image.open(files / f"{i + 1}.png"), np.int16)
        assert np.abs(got - img).max() <= 1, i


# ---------------------------------------------------------------------------
# UNet2D dropout
# ---------------------------------------------------------------------------

def test_unet2d_dropout_matches_the_reference():
    """The reference's forward with deterministic=False: its keep masks
    recorded in call order (NHWC) and handed to the port's forward; and
    deterministic, the dropout-free forward, on both sides."""
    import jax
    import jax.numpy as jnp

    from polyp_tpu.models import unet2d as junet
    from polyp_tpu_torch.models import importers as timp
    from polyp_tpu_torch.models import unet2d as tunet
    from test_torch_port_scratch import TWO_LEVELS, _nchw, _params

    config = dict(block_out_channels=(32, 32), **TWO_LEVELS)
    jm = junet.UNet2D(**config, dropout=0.25)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    t = np.array([3, 700], np.int32)
    params = _params(jm, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32),
                     seed=4)
    tm = tunet.UNet2D(**config, dropout=0.25)
    tm.load_state_dict(timp.unet2d_from_jax(params), strict=True)
    tm.eval()

    bernoulli = jax.random.bernoulli

    def forward(params, x, t):
        recorded = []

        def record(*args, **kwargs):
            recorded.append(bernoulli(*args, **kwargs))
            return recorded[-1]

        with mock.patch.object(jax.random, "bernoulli", record):
            out = jm.apply({"params": params}, x, t, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(9)})
        return out, recorded

    want, masks = jax.jit(forward)(params, jnp.asarray(x), jnp.asarray(t))
    masks = [np.array(m) for m in masks]
    assert len(masks) == 2 + 2 + 4  # down, mid and up resnets
    queue = [torch.from_numpy(m.transpose(0, 3, 1, 2).copy()) for m in masks]

    def keep(name, shape):
        mask = queue.pop(0)
        assert tuple(mask.shape) == shape, name
        return mask

    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                 torch.from_numpy(t).long(), dropout_keep=keep)
        plain = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                   torch.from_numpy(t).long())
    assert not queue
    want = _nchw(want)
    assert ((got - want).norm() / want.norm()).item() <= 1e-5
    jplain = _nchw(jm.apply({"params": params}, jnp.asarray(x),
                            jnp.asarray(t)))
    assert ((plain - jplain).norm() / jplain.norm()).item() <= 1e-5
    assert ((got - plain).norm() / plain.norm()).item() > 1e-2
