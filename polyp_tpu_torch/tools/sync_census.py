"""How often a training step of the port's bench makes the host wait for the
card: each chained train bench of cli/bench.py (bench_classifier_train,
bench_sd_lora_train, bench_distill_train) runs under
torch.cuda.set_sync_debug_mode("warn") at two chain lengths (CHAINS), with one
repeat (a warm-up chain and a timed one, each ended by its one loss
fetch). The difference of the two runs' synchronising calls, by Python
line, over the difference of their steps is what a step makes by itself:
the models' build and the fetches cancel.

    python -m polyp_tpu_torch.tools.sync_census [--out chiprun_out/sync_census.json]

On the card only: the sync debug mode watches CUDA streams.
"""

from __future__ import annotations

import argparse
import json
import warnings
from collections import Counter
from pathlib import Path

import torch

from polyp_tpu_torch.cli import bench

BENCHES = {"classifier": bench.bench_classifier_train,
           "sd_lora": bench.bench_sd_lora_train,
           "distill": bench.bench_distill_train}
# steps a chain in the two runs of each bench
CHAINS = (2, 4)


def _where(filename: str, lineno: int) -> str:
    """file:line, from the package root for the port's own files."""
    parts = Path(filename).parts
    if "polyp_tpu_torch" in parts:
        parts = parts[len(parts) - parts[::-1].index("polyp_tpu_torch"):]
    else:
        parts = parts[-1:]
    return f"{'/'.join(parts)}:{lineno}"


def synchronising_calls(fn) -> Counter:
    """The Python lines of the synchronising calls fn() makes, counted."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return Counter(_where(w.filename, w.lineno) for w in seen
                   if "called a synchronizing" in str(w.message))


def per_step(short: Counter, long: Counter, extra_steps: int) -> dict:
    """Synchronising calls a step, by line: (long − short) / extra_steps,
    lines whose count did not change left out."""
    return {k: (long[k] - short[k]) / extra_steps
            for k in sorted(set(short) | set(long)) if long[k] != short[k]}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sync_census needs a CUDA card")
    out = {"card": bench.card_name("cuda")}
    for name, fn in BENCHES.items():
        counts = [synchronising_calls(lambda n=n: fn(chain=n, repeats=1))
                  for n in CHAINS]
        torch.cuda.empty_cache()
        # two chains a run: the warm-up and the timed one
        steps = per_step(*counts, 2 * (CHAINS[1] - CHAINS[0]))
        out[name] = {"per_step": steps, "total_per_step": sum(steps.values()),
                     "calls": {str(n): sum(c.values()) for n, c in
                               zip(CHAINS, counts)}}
        print(f"[sync_census] {name}: {out[name]['total_per_step']:g} "
              f"synchronising calls a step: {steps}", flush=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
