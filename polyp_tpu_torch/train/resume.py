"""Epoch-level train-state snapshots and resume: the twin of
polyp_tpu/train/resume.py, on utils/checkpoint.py's format.

A snapshot is a nested dict of tensors and numbers (for the LoRA trainer
`SDTrainState.tree()`: step, trainables, optimizer state) saved every
`every` epochs as `{dir}/epoch_{n}.pt`, with `aux_{n}.json` (small trainer
extras such as the loss history) and a `latest.json` pointer written last;
older snapshots are pruned to `keep`. Under a data-parallel group
(`mesh`) rank 0 alone writes, the others wait for it, and every rank
restores from the same files.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from polyp_tpu_torch.parallel import mesh as pmesh
from polyp_tpu_torch.utils.checkpoint import load_pytree, save_pytree


class EpochCheckpointer:

    def __init__(self, ckpt_dir: str | Path, every: int = 10, keep: int = 2,
                 mesh: pmesh.DataMesh | None = None):
        self.dir = Path(ckpt_dir)
        self.every = max(every, 1)
        self.keep = max(keep, 1)
        self.mesh = mesh

    def _latest_path(self) -> Path:
        return self.dir / "latest.json"

    def due(self, epoch: int) -> bool:
        """Is a snapshot due after `epoch`?"""
        return (epoch + 1) % self.every == 0

    def save(self, epoch: int, tree: Any, force: bool = False,
             aux: dict | None = None) -> bool:
        """Snapshot `tree` after `epoch` when it is due (or `force`); True
        when it was, on every rank of the mesh."""
        if not force and not self.due(epoch):
            return False
        if pmesh.is_writer(self.mesh):
            save_pytree(self.dir / f"epoch_{epoch}.pt", tree)
            if aux is not None:
                (self.dir / f"aux_{epoch}.json").write_text(json.dumps(aux))
            self._latest_path().write_text(json.dumps({"epoch": epoch}))
            self._prune()
        pmesh.barrier(self.mesh)
        return True

    def _prune(self) -> None:
        snaps = sorted((int(p.stem.split("_")[1]), p)
                       for p in self.dir.glob("epoch_*.pt"))
        for epoch, path in snaps[: max(0, len(snaps) - self.keep)]:
            path.unlink(missing_ok=True)
            (self.dir / f"aux_{epoch}.json").unlink(missing_ok=True)

    def latest_epoch(self) -> int | None:
        if not self._latest_path().exists():
            return None
        return int(json.loads(self._latest_path().read_text())["epoch"])

    def restore(self, like: Any) -> tuple[Any, int] | None:
        """(tree, next epoch) from the newest snapshot, each tensor on its
        counterpart's device in `like`; None when there is none."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        return load_pytree(self.dir / f"epoch_{epoch}.pt", like), epoch + 1

    def restore_aux(self) -> dict | None:
        """The trainer extras saved with the newest snapshot."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        path = self.dir / f"aux_{epoch}.json"
        return json.loads(path.read_text()) if path.exists() else None


def resume_or_init(ckptr: EpochCheckpointer | None,
                   init_tree: Any) -> tuple[Any, int]:
    """(the newest snapshot and the epoch after it) or (`init_tree`, 0)."""
    if ckptr is not None:
        restored = ckptr.restore(init_tree)
        if restored is not None:
            return restored
    return init_tree, 0
