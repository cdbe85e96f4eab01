"""Cross-run summary generation: ``summary.md`` and ``_summary/summary.csv``
(the port's own copy of ``genomics_lm_tpu/evals/summaries.py``, byte-equal
output). ``training/config.py::write_meta`` calls it best-effort after each
``meta.json``, as JAX's does.
"""

from __future__ import annotations

import csv
from pathlib import Path

from genomics_lm_torch.evals.aggregator import load_all_runs, summary_rows


def generate_summary(runs_root: str | Path) -> Path:
    """Write ``<root>/summary.md`` and ``<root>/_summary/summary.csv`` over
    every run under ``runs_root``; returns the markdown's path."""
    runs_root = Path(runs_root)
    rows = summary_rows(load_all_runs(runs_root))
    summary_dir = runs_root / "_summary"
    summary_dir.mkdir(parents=True, exist_ok=True)

    csv_path = summary_dir / "summary.csv"
    if rows:
        with csv_path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)

    md_lines = ["# Run summary", ""]
    if rows:
        headers = list(rows[0].keys())
        md_lines.append("| " + " | ".join(headers) + " |")
        md_lines.append("|" + "|".join("---" for _ in headers) + "|")
        for row in rows:
            md_lines.append("| " + " | ".join(str(row[h]) for h in headers) + " |")
    else:
        md_lines.append("_no runs found_")
    md_path = runs_root / "summary.md"
    md_path.write_text("\n".join(md_lines) + "\n")
    return md_path


__all__ = ["generate_summary"]
