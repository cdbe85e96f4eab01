"""Write one summary table row for every run under a root (twin of
``scripts/generate_run_summaries.py``, the same flags).

    python -m genomics_lm_torch.evals.generate_run_summaries [--run_root runs] \\
        [--out runs/summaries.csv]

Reads files only (``evals/aggregator.py``); prints the row count and the
output path as JSON.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--out", default=None, help="default: <run_root>/summaries.csv")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.aggregator import load_all_runs, summary_rows

    rows = summary_rows(load_all_runs(args.run_root))
    out = Path(args.out) if args.out else Path(args.run_root) / "summaries.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()) if rows else ["run_id"])
        writer.writeheader()
        writer.writerows(rows)
    print(json.dumps({"runs": len(rows), "out": str(out)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
