"""Seeding contracts: the port's form of polyp_tpu/utils/rng.py.

Three contracts, kept apart:

* generation batch `i` of a quota run is drawn from the generator seeded
  `seed + i` (`batch_generator`), the reference CLI's
  `torch.Generator('cpu').manual_seed(config.seed + batch_id)`, so a top-up
  resumes at batch `existing // eval_batch` and regenerates identical
  batches (pipeline.py::top_up_samples);
* sample `index` of a served request with seed `seed` is drawn from the
  generator seeded `request_seed(seed, index)` (`request_generator`), a
  pure function of the pair, so a response does not depend on what it was
  coalesced with or on how its images were split over requests
  (serve.py);
* every random draw of a training step comes from the generator seeded
  `stream_seed(seed, *streams)` (`stream_generator`), e.g. `(seed,
  "sd_lora", epoch, step)`: a pure function of the path, as the
  reference's `key_for(seed, "sd_lora", epoch, step)` is, so a resumed run
  draws what an uninterrupted one would.

torch's Philox and JAX's threefry draw different numbers from the same
seed, and a torch seed cannot reproduce a folded JAX key: the port's
samples for a given seed are not the JAX package's. Given the same initial
latents the two agree to rounding (tests/test_torch_port_serve.py).
"""

from __future__ import annotations

import hashlib

import torch


def batch_seed(seed: int, batch_id: int) -> int:
    """The seed of generation batch `batch_id`: `seed + batch_id`."""
    return seed + batch_id


def batch_generator(seed: int, batch_id: int,
                    device: torch.device | str) -> torch.Generator:
    """A generator on `device` seeded `batch_seed(seed, batch_id)`."""
    return torch.Generator(device).manual_seed(batch_seed(seed, batch_id))


def request_seed(seed: int, index: int) -> int:
    """The seed of sample `index` of a request seeded `seed`: the first 8
    bytes of SHA-256("polyp-request/{seed}/{index}") as a little-endian
    integer with its top bit cleared (a 63-bit seed). Hashing keeps
    distinct (seed, index) pairs apart from each other and from the
    batch seeds `seed + i` at any grid a caller uses (a collision needs a
    63-bit hash collision)."""
    digest = hashlib.sha256(f"polyp-request/{seed}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def request_generator(seed: int, index: int,
                      device: torch.device | str) -> torch.Generator:
    """A generator on `device` seeded `request_seed(seed, index)`."""
    return torch.Generator(device).manual_seed(request_seed(seed, index))


def stream_seed(seed: int, *streams: str | int) -> int:
    """The seed of the stream path `streams` under `seed`: the first 8
    bytes of SHA-256("polyp-stream/{seed}/{s1}/{s2}/...") as a
    little-endian integer with its top bit cleared. Strings and integers
    are written apart (`s:name`, `i:7`), so a name cannot alias an
    index."""
    path = "/".join(f"s:{s}" if isinstance(s, str) else f"i:{int(s)}"
                    for s in streams)
    digest = hashlib.sha256(f"polyp-stream/{seed}/{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def stream_generator(seed: int, *streams: str | int,
                     device: torch.device | str = "cpu") -> torch.Generator:
    """A generator on `device` seeded `stream_seed(seed, *streams)`."""
    return torch.Generator(device).manual_seed(stream_seed(seed, *streams))
