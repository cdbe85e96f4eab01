"""Run the six-step interpretability analysis on a trained run (twin of
``scripts/run_analysis.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.run_analysis <run_id> --val_npz val.npz \\
        [--probe_dna ATGAAACCCGGGTTT] [--run_root runs] [--device cpu]

Writes the charts and tables of ``evals/analysis.py::run_full_analysis``
into the run's directory and prints each step's report as JSON.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--val_npz", required=True)
    ap.add_argument("--probe_dna", default="ATGAAACCCGGGTTT")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.analysis import run_full_analysis
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    steps = run_full_analysis(run_dir, args.val_npz, probe_dna=args.probe_dna,
                              device=args.device)
    print(json.dumps(steps, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
