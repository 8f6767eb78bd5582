"""The multichip dry run's deviations from one process with a fault
planted in the ranks: the reading that parallel/dryrun.py's
MODEL_AXIS_TOLERANCES must stay below.

    python -m polyp_tpu_torch.tools.dryrun_fault [--ranks 4]
        [--device cuda] [--fault skip_g]

The ranks run `dryrun.run_phases` on the dry run's mesh
(`dryrun.mesh_spec`) with one collective of the model axis replaced:

* `skip_g`: Megatron's g returns each rank's own partial product, so the
  row-parallel sums (attention out-projections, FF down-projections)
  miss the other ranks' slices;
* `local_scales`: the model group's max (`model_max`) returns each rank's
  own value, so a row-parallel layer's int8 weight scales, dynamic scale
  and calibration amax see only its slice of the input features.

Prints one JSON object: each phase's max |group − one process| (relative
for the losses and gradients), as `dryrun.compare` reads it, beside the
phase's limit.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from polyp_tpu_torch.parallel import dryrun

FAULTS = ("skip_g", "local_scales")


def plant(fault: str) -> None:
    """Replace the collective `fault` names in this process."""
    from polyp_tpu_torch.models import unet_blocks
    from polyp_tpu_torch.ops import quant

    if fault == "skip_g":
        unet_blocks.reduce_from_model = lambda x, mesh: x
    elif fault == "local_scales":
        quant.model_max = lambda x, mesh: x
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")


def _faulty_rank(mesh, device: str, fault: str) -> dict:
    plant(fault)
    return dryrun._rank(mesh, device)


def readings(n: int, device: str, fault: str,
             timeout: float = 900.0) -> dict:
    """Each phase's deviation from one process with `fault` planted in
    the `n` ranks (the one-process run is sound)."""
    from polyp_tpu_torch.parallel.launch import spawn_group

    dev = torch.device(device)
    share = dev.type == "cuda" and n > torch.cuda.device_count()
    if dev.type == "cuda":
        from polyp_tpu_torch import _build
        _build.build()
    spec = dryrun.mesh_spec(n)
    saved = os.environ.get("POLYP_TORCH_QUANT_CACHE")
    with tempfile.TemporaryDirectory(prefix="polyp-fault-") as cache:
        os.environ["POLYP_TORCH_QUANT_CACHE"] = cache
        try:
            ranks = spawn_group(_faulty_rank, n, (device, fault), "gloo",
                                device, share_device=share, timeout=timeout,
                                spec=spec)
            single = dryrun.run_phases(None, device, ranks[0]["data_ranks"],
                                       "model" in spec)
        finally:
            if saved is None:
                os.environ.pop("POLYP_TORCH_QUANT_CACHE", None)
            else:
                os.environ["POLYP_TORCH_QUANT_CACHE"] = saved
    limits = (dryrun.MODEL_AXIS_TOLERANCES if "model" in spec
              else dryrun.TOLERANCES)
    errors = dryrun.compare(ranks[0], single,
                            {"images": float("inf"),
                             **{k: float("inf") for k in limits}})
    return {"ranks": n, "mesh": spec, "device": device, "fault": fault,
            "errors": errors, "limits": limits}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--fault", choices=FAULTS, default="skip_g")
    args = parser.parse_args(argv)
    report = readings(args.ranks, args.device, args.fault)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
