"""Tracing, throughput and NaN hooks: the twin of
polyp_tpu/utils/profiling.py on torch.

* `trace(logdir)` — a torch.profiler region (CPU activity, and CUDA
  activity where a card is present) written to `logdir` as a Chrome trace
  (view it in Perfetto or chrome://tracing);
* `graph_ms(fn)` — the device time of one call of `fn` on the card, from
  calls captured in a CUDA graph and replayed between CUDA events (no
  host work in it), the timer of tools/roofline.py;
* `Throughput` — samples/s on the host clock between synchronisation
  points, the instrument behind tools/quant_sensitivity.py's throughput
  half of the quant gate;
* `enable_nan_checks` / `debug_nans` — torch's anomaly mode, which raises
  where a backward produces a NaN and names the forward op that made it.

The reference's `xla_dump` has no torch counterpart (ROADMAP.md item 14).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the region; on exit write `logdir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call of `fn`: `iters` calls captured once in a
    CUDA graph (after warm-up calls on a side stream), the graph replayed
    `replays` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


class Throughput:
    """Wall-clock samples/s with device-sync brackets.

    >>> tp = Throughput()
    >>> with tp.measure(n_samples=batch):
    ...     out = step(...)
    ...     tp.sync(out)            # waits for the card inside the bracket
    >>> tp.samples_per_sec
    """

    def __init__(self):
        self.total_samples = 0
        self.total_seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_samples: int) -> Iterator["Throughput"]:
        t0 = time.perf_counter()
        yield self
        self.total_seconds += time.perf_counter() - t0
        self.total_samples += n_samples

    @staticmethod
    def sync(tree) -> None:
        """Wait for the card that holds the tensors in `tree` (a tensor, or
        lists, tuples and dicts of them); nothing for CPU tensors."""
        devices = set()

        def walk(node):
            if isinstance(node, torch.Tensor):
                if node.device.type == "cuda":
                    devices.add(node.device)
            elif isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)

        walk(tree)
        for device in devices:
            torch.cuda.synchronize(device)

    @property
    def samples_per_sec(self) -> float:
        return (self.total_samples / self.total_seconds
                if self.total_seconds else 0.0)


def enable_nan_checks(enabled: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enabled)


@contextlib.contextmanager
def debug_nans() -> Iterator[None]:
    prev = torch.is_anomaly_enabled()
    enable_nan_checks(True)
    try:
        yield
    finally:
        enable_nan_checks(prev)
