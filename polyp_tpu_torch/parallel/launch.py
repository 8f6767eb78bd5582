"""Spawn a process group in this process's children: `spawn_group(fn,
world_size)` runs `fn(mesh, *args)` on each of `world_size` ranks and
returns their results in rank order. The mesh is the data mesh over every
rank, or the one `spec` names ("data=2,model=2", parallel/mesh.py).

The ranks are started by multiprocessing's spawn method (never fork: a
parent that has touched CUDA cannot fork a child that uses it), meet over a
`FileStore` in a fresh temporary directory (no port to collide with), and
hand their results back through files (`torch.save`, tensors moved to the
CPU). A rank that raises, exits or outlives `timeout` fails the whole
group: `spawn_group` stops every rank it started and raises; it never
falls back to fewer ranks. The ranks split this process's intra-op
threads between them.

On one card, several ranks can share `cuda:0` over gloo (NCCL refuses two
ranks on one device): pass `device="cuda"`, `backend="gloo"` and
`share_device=True`. Build the kernels before spawning, so the ranks load
the built library instead of racing to build it.
"""

from __future__ import annotations

import multiprocessing as mp
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(fn: Callable, rank: int, world_size: int, store: str,
               backend: str, device: str, share_device: bool, out: str,
               threads: int, args: tuple, spec: str | None) -> None:
    import torch.distributed as dist

    from polyp_tpu_torch.parallel.mesh import (
        current_mesh, init_group, mesh_from_spec)

    torch.set_num_threads(threads)
    try:
        init_group(backend, rank, world_size, f"file://{store}", device,
                   local_rank=0 if share_device else rank)
        try:
            mesh = mesh_from_spec(spec) if spec else current_mesh()
            result = fn(mesh, *args)
            torch.save({"ok": _to_cpu(result)}, out)
        finally:
            dist.destroy_process_group()
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def spawn_group(fn: Callable[..., Any], world_size: int, args: tuple = (),
                backend: str = "gloo", device: str = "cpu",
                share_device: bool = False, timeout: float = 600.0,
                spec: str | None = None) -> list[Any]:
    """`fn(mesh, *args)` on `world_size` spawned ranks (`fn` and `args`
    picklable, `fn` importable by name); their results in rank order.
    `spec` names the mesh (default: data over every rank)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="polyp-group-") as tmp:
        store = str(Path(tmp) / "store")
        outs = [str(Path(tmp) / f"rank{r}.pt") for r in range(world_size)]
        # the ranks split this process's intra-op threads: oversubscribed
        # threads spin against each other at every collective
        threads = max(1, torch.get_num_threads() // world_size)
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, store, backend, device, share_device,
            outs[r], threads, args, spec), daemon=True)
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # one rank failed: the others may wait forever
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the {world_size}-rank group did not finish within "
                        f"{timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            got = (torch.load(out, weights_only=False)
                   if Path(out).exists() else {})
            if "ok" in got and p.exitcode == 0:
                results.append(got["ok"])
            else:
                errors.append(f"rank {r} (exit code {p.exitcode}):\n"
                              + got.get("error", "no result"))
        if errors:
            raise RuntimeError("process group failed:\n"
                               + "\n".join(errors))
        return results
