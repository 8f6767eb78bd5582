"""Synthetic-image quota math: a copy of polyp_tpu/eval/quota.py without
pandas.

How many synthetic images each class needs so the augmented training set
reaches a target class distribution with a minimum AD count.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

from polyp_tpu_torch.data.tables import read_rows


def counts_per_class(train_csv: str | Path) -> dict[str, int]:
    """Real per-class training counts from the labels CSV, most frequent
    first (pandas' value_counts order)."""
    counts = Counter(row["cls"] for row in read_rows(train_csv))
    return dict(counts.most_common())


def get_num_images_to_generate(
    real_counts: dict[str, int],
    distribution: tuple[float, ...],
    ad_minimum: int = 1000,
    one_vs_rest: bool = False,
) -> dict[str, int]:
    """Per-class synthetic quotas.

    total_target = max(count_AD, ad_minimum) / distribution[0]; each class's
    target is its distribution share of that total; quota = max(0, target -
    real). Three-class uses (AD, HP, ASS) shares; one-vs-rest uses
    (AD, REST=HP+ASS).
    """
    ad_target = max(real_counts["AD"], ad_minimum)
    total_target = int(ad_target / distribution[0])

    if one_vs_rest:
        rest_count = real_counts.get("HP", 0) + real_counts.get("ASS", 0)
        rest_target = int(total_target * distribution[1])
        return {
            "AD": max(0, ad_target - real_counts["AD"]),
            "REST": max(0, rest_target - rest_count),
        }

    hp_target = int(total_target * distribution[1])
    ass_target = int(total_target * distribution[2])
    return {
        "AD": max(0, ad_target - real_counts["AD"]),
        "HP": max(0, hp_target - real_counts.get("HP", 0)),
        "ASS": max(0, ass_target - real_counts.get("ASS", 0)),
    }


def default_distribution(one_vs_rest: bool) -> tuple[float, ...]:
    """(0.6, 0.4) one-vs-rest, else (0.4, 0.3, 0.3)."""
    return (0.6, 0.4) if one_vs_rest else (0.4, 0.3, 0.3)
