"""Multi-run results aggregation for the dashboard and run summaries (the
port's own copy of ``genomics_lm_tpu/evals/aggregator.py``): the metrics,
meta, curves, checkpoints and completion marker of every run under a runs
root, tolerating missing or unreadable files. Reads files only; a run
written by either trainer reads the same.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path


def load_run(run_dir: str | Path) -> dict:
    run_dir = Path(run_dir)
    out: dict = {"run_id": run_dir.name, "path": str(run_dir)}
    metrics_path = run_dir / "scores" / "metrics.json"
    if metrics_path.exists():
        try:
            out["metrics"] = json.loads(metrics_path.read_text())
        except json.JSONDecodeError:
            out["metrics"] = None
    meta_path = run_dir / "checkpoints" / "meta.json"
    if meta_path.exists():
        try:
            out["meta"] = json.loads(meta_path.read_text())
        except json.JSONDecodeError:
            out["meta"] = None
    curves_path = run_dir / "scores" / "curves.csv"
    if curves_path.exists():
        with curves_path.open(newline="") as f:
            rows = list(csv.DictReader(f))
        out["curves"] = rows
    out["complete"] = (run_dir / "run_complete.json").exists()
    checkpoints = run_dir / "checkpoints"
    if checkpoints.exists():
        out["checkpoints"] = sorted(p.name for p in checkpoints.glob("*.npz"))
    return out


def load_all_runs(root: str | Path) -> list[dict]:
    root = Path(root)
    if not root.exists():
        return []
    runs = []
    for run_dir in sorted(root.iterdir()):
        if run_dir.is_dir() and not run_dir.name.startswith("_"):
            runs.append(load_run(run_dir))
    return runs


def summary_rows(runs: list[dict]) -> list[dict]:
    rows = []
    for run in runs:
        meta = run.get("meta") or {}
        rows.append(
            {
                "run_id": run["run_id"],
                "status": meta.get("status"),
                "best_epoch": meta.get("best_epoch"),
                "best_val_loss": meta.get("best_val_loss"),
                "last_perplexity": meta.get("last_perplexity"),
                "n_params": meta.get("n_params"),
                "complete": run.get("complete"),
            }
        )
    return rows


__all__ = ["load_all_runs", "load_run", "summary_rows"]
