#!/usr/bin/env python3
"""Convert the JAX package's trained tiny decoder for polyp_tpu_torch.

    JAX_PLATFORMS=cpu python tools/convert_tiny_decoder.py \
        [--src models/tiny_decoder] [--dst polyp_tpu_torch/weights/tiny_decoder]

Reads the orbax checkpoint with polyp_tpu's own `load_tiny_decoder` (so
both packages serve the same weights), converts it with
`polyp_tpu_torch.models.importers.tiny_decoder_from_jax` (conv kernels HWIO
→ OIHW, flax names kept) and writes `params.npz` (fp32, the port's state
dict keys) and a copy of `meta.json` to the destination. The port reads
only those two files: a machine without JAX and orbax cannot read the
checkpoint. This script needs JAX; the port never imports it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "models" / "tiny_decoder"))
    ap.add_argument("--dst", default=str(
        ROOT / "polyp_tpu_torch" / "weights" / "tiny_decoder"))
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from polyp_tpu.models.tiny_decoder import load_tiny_decoder
    from polyp_tpu_torch.models.importers import tiny_decoder_from_jax

    _, params, meta = load_tiny_decoder(args.src)
    state = tiny_decoder_from_jax(jax.device_get(params))
    dst = Path(args.dst)
    dst.mkdir(parents=True, exist_ok=True)
    np.savez(dst / "params.npz",
             **{k: v.numpy() for k, v in sorted(state.items())})
    shutil.copyfile(Path(args.src) / "meta.json", dst / "meta.json")
    n = sum(v.numel() for v in state.values())
    print(json.dumps({"tensors": len(state), "params": n,
                      "dst": str(dst), "meta": meta}))


if __name__ == "__main__":
    main()
