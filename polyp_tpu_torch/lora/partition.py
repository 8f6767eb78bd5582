"""Trainability by parameter path: the twin of polyp_tpu/lora/partition.py.

The reference's `--unfreeze_layers` picks base weights by substring
(`any(x in name ...)`); here a mask over a parameter dict picks them, and
`extract_by_mask` / `overlay_params` take the subset out and put it back
functionally, leaving the modules untouched. Trees are nested dicts of
tensors; a flat dict of the port's parameter names is one, whose paths are
the names (`...attn1.to_q.weight`).
"""

from __future__ import annotations

from typing import Any, Sequence


def path_mask(params: Any, substrings: Sequence[str]) -> Any:
    """Mask tree: True where any substring occurs in the '/'-joined path."""

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        return any(s in path for s in substrings)

    return walk(params, "")


def extract_by_mask(params: Any, mask: Any) -> Any:
    """Subtree of `params` with the mask-True leaves only (empty branches
    dropped). The leaves are `params`' own tensors: copy them before
    training them."""

    def walk(p, m):
        if isinstance(p, dict):
            out = {}
            for k, v in p.items():
                sub = walk(v, m[k])
                if sub is not None and (not isinstance(sub, dict) or sub):
                    out[k] = sub
            return out
        return p if m else None

    return walk(params, mask)


def overlay_params(base: Any, subset: Any) -> Any:
    """`base` with the leaves of `subset` in place of its own (a new tree;
    neither argument changes)."""
    if not isinstance(base, dict):
        return subset if subset is not None else base
    return {k: overlay_params(v, subset[k])
            if isinstance(subset, dict) and k in subset else v
            for k, v in base.items()}


def trainable_count(params: Any, mask: Any) -> tuple[int, int]:
    """(trainable, total) parameter counts under a mask."""

    def walk(p, m):
        if isinstance(p, dict):
            pairs = [walk(v, m[k]) for k, v in p.items()]
            return (sum(a for a, _ in pairs), sum(b for _, b in pairs))
        return (p.numel() if m else 0, p.numel())

    return walk(params, mask)
