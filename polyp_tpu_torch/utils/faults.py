"""Deterministic fault injection for crash-resume testing: a copy of
polyp_tpu/utils/faults.py (the port imports nothing of the JAX package).

The trainers' epoch-level resume (train/resume.py) is verified end to end
by killing a real training CLI mid-run and requiring the restarted run to
match an uninterrupted one. The kill has to be abrupt (no finally blocks,
no buffered-file flushes) and land at a reproducible point, so the
trainer loops call `maybe_crash("epoch", n)` right after each snapshot,
and a test arms it through the environment, with the reference's
variable:

    POLYP_TPU_CRASH_AT="epoch:1"   # SIGKILL self after epoch 1's snapshot

Unset (production), the probe is a single dict lookup.
"""

from __future__ import annotations

import os
import signal

ENV_VAR = "POLYP_TPU_CRASH_AT"


def maybe_crash(point: str, index: int) -> None:
    """SIGKILL the process when `POLYP_TPU_CRASH_AT == f"{point}:{index}"`.

    SIGKILL (not sys.exit) so nothing downstream of the kill (terminal
    snapshots, artifact uploads, tracker flushes) can run."""
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return
    want_point, _, want_index = spec.rpartition(":")
    if want_point == point and want_index == str(index):
        os.kill(os.getpid(), signal.SIGKILL)
