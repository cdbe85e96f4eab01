"""Aggregate the runs under a root into ``_summary`` (twin of
``scripts/compare_runs.py``, the same flags). Host only: reads and writes
files.

    python -m genomics_lm_torch.evals.compare_runs [--root runs] \\
        [--metric best_val_loss]

Writes ``summary.md`` and ``_summary/summary.csv`` (``evals/summaries.py``)
and the bar chart ``_summary/comparison_<metric>.png`` of one ``meta.json``
metric (not drawn where matplotlib is not installed: one line says so),
then prints every run's summary row as JSON.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="runs")
    ap.add_argument("--metric", default="best_val_loss",
                    help="also render a comparison chart for this metric")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.aggregator import load_all_runs, summary_rows
    from genomics_lm_torch.evals.summaries import generate_summary
    from genomics_lm_torch.evals.visualizer import plot_run_comparison

    runs = load_all_runs(args.root)
    md = generate_summary(args.root)
    try:
        plot_run_comparison(
            runs, args.metric, f"{args.root}/_summary/comparison_{args.metric}.png"
        )
    except Exception as exc:
        print(f"[warn] comparison plot failed: {exc}")
    print(json.dumps(summary_rows(runs), indent=2))
    print(f"[compare] summary → {md}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
