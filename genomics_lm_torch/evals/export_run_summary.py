"""Bundle a run's analysis outputs into one summary (twin of
``scripts/export_run_summary.py``, the same flags).

    python -m genomics_lm_torch.evals.export_run_summary <run_id> [--run_root runs]

Collects the ``tables/{frequencies,next_token_probe,saliency}.json`` and
``scores/*.json`` already in the run and writes
``tables/run_summary.{json,md}``. Reads and writes files only.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--run_root", default="runs")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.analysis import export_run_summary
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    steps = {}
    tables = run_dir / "tables"
    for name in ("frequencies", "next_token_probe", "saliency"):
        path = tables / f"{name}.json"
        if path.exists():
            payload = json.loads(path.read_text())
            steps[name] = payload if isinstance(payload, dict) else {"rows": len(payload)}
    scores = run_dir / "scores"
    for path in sorted(scores.glob("*.json")) if scores.is_dir() else []:
        try:
            steps[f"scores/{path.stem}"] = json.loads(path.read_text())
        except json.JSONDecodeError:
            continue
    out = export_run_summary(run_dir, steps, tables)
    print(json.dumps({"summary": str(out), "sections": sorted(steps)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
