"""Dataset analysis (the reference's data_analysis notebook): the twin of
polyp_tpu/eval/analysis.py without pandas (the card's machine has none).

Split sizes and class-distribution summaries and pies for the polyp
corpus, from data/tables.py's csv reader. Class counts come in the order
of pandas' `value_counts`: by count, descending, ties in the order the
classes first appear. `split_stats` gives one row a split, every row with
every split's `n_{cls}` column (0 where the split has none, pandas'
`fillna(0)`), in the order the columns first appear.
"""

from __future__ import annotations

from pathlib import Path

from polyp_tpu_torch.data.tables import read_rows


def value_counts(csv_path: str | Path) -> list[tuple[str, int]]:
    """(class, count) pairs of a labels CSV's `cls` column, in pandas'
    `value_counts` order."""
    counts: dict[str, int] = {}
    for row in read_rows(csv_path):
        counts[row["cls"]] = counts.get(row["cls"], 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[1])  # a stable sort


def split_stats(csv_paths: dict[str, str | Path]) -> list[dict]:
    """Per-split sizes and class counts: one row a split ({"split",
    "total", "n_{cls}"...}). For the reference corpus this reproduces
    788/113/225 and AD 535 / HP 131 / ASS 122."""
    rows = []
    for split, csv_path in csv_paths.items():
        counts = dict(value_counts(csv_path))
        rows.append({"split": split, "total": sum(counts.values()),
                     **{f"n_{k}": v for k, v in sorted(counts.items())}})
    columns = list(dict.fromkeys(k for row in rows for k in row))
    return [{k: row.get(k, 0) for k in columns} for row in rows]


def class_distribution(csv_path: str | Path) -> dict[str, float]:
    counts = value_counts(csv_path)
    total = sum(n for _, n in counts)
    return {str(k): float(v) / total for k, v in counts}


def imbalance_ratio(csv_path: str | Path) -> float:
    """The majority / minority count ratio: the problem in one number."""
    counts = [n for _, n in value_counts(csv_path)]
    return float(max(counts) / min(counts))


def format_table(rows: list[dict]) -> str:
    """The rows as right-aligned text columns under their names (the
    reference prints `DataFrame.to_string(index=False)`)."""
    columns = list(rows[0]) if rows else []
    cells = [columns] + [[str(r[c]) for c in columns] for r in rows]
    widths = [max(len(line[i]) for line in cells)
              for i in range(len(columns))]
    return "\n".join(" ".join(v.rjust(w) for v, w in zip(line, widths))
                     for line in cells)


def plot_distribution_pies(csv_paths: dict[str, str | Path],
                           filename: str) -> str:
    """A class-distribution pie per split; without matplotlib, the pies'
    data as JSON beside `filename` (utils/plotting.py)."""
    from polyp_tpu_torch.utils.plotting import _as_json, _plt

    data = {split: value_counts(p) for split, p in csv_paths.items()}
    plt = _plt()
    if plt is None:
        return _as_json(filename, {
            "title": "class distribution",
            "splits": {s: dict(c) for s, c in data.items()}})
    fig, axes = plt.subplots(1, len(data), figsize=(5 * len(data), 5))
    if len(data) == 1:
        axes = [axes]
    for ax, (split, counts) in zip(axes, data.items()):
        ax.pie([n for _, n in counts], labels=[c for c, _ in counts],
               autopct="%1.1f%%")
        ax.set_title(f"{split} (n={sum(n for _, n in counts)})")
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(filename)
    plt.close(fig)
    return filename


def main(argv=None) -> list[dict]:
    import argparse

    from polyp_tpu_torch.cli.common import DataLayout

    parser = argparse.ArgumentParser()
    parser.add_argument("--data-root", type=str, default="./data")
    parser.add_argument("--out", type=str,
                        default="results/class_distribution.png")
    args = parser.parse_args(argv)
    layout = DataLayout(Path(args.data_root))
    csvs = {"train": layout.train_csv, "valid": layout.val_csv,
            "test": layout.test_csv}
    stats = split_stats(csvs)
    print(format_table(stats))
    print(f"train imbalance ratio: {imbalance_ratio(layout.train_csv):.2f}")
    print(f"pies at {plot_distribution_pies(csvs, args.out)}")
    return stats


if __name__ == "__main__":
    main()
