"""Compare two codon generators under the same critic (twin of
``scripts/compare_generators.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.generation.compare_generators \\
        --baseline_dir <run> --finetuned_dir <run> [--critic_ckpt critic.npz] \\
        [--n_sequences 8] [--target_codons 24] [--seed 0] \\
        [--out_dir outputs/reports/generator_comparison] [--device cpu]

Runs the port's design loop (``python -m
genomics_lm_torch.generation.generative_design_loop``) as a subprocess on
each run, with the same candidates, target, seed and critic, into
``<out_dir>/baseline`` and ``<out_dir>/finetuned``; then writes
``<out_dir>/comparison.json`` with both summaries and the fine-tuned run's
delta on each numeric key, and prints it. ``--device`` is passed on to
both loops (the card unless it names another).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline_dir", required=True)
    ap.add_argument("--finetuned_dir", required=True)
    ap.add_argument("--critic_ckpt", default=None)
    ap.add_argument("--n_sequences", type=int, default=8)
    ap.add_argument("--target_codons", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default="outputs/reports/generator_comparison")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def design_loop(run_id: str, out_dir: Path, args) -> dict:
    cmd = [
        sys.executable, "-m", "genomics_lm_torch.generation.generative_design_loop",
        run_id, "--n_candidates", str(args.n_sequences),
        "--target_codons", str(args.target_codons),
        "--seed", str(args.seed), "--out_dir", str(out_dir),
        "--run_root", args.run_root,
    ]
    if args.critic_ckpt:
        cmd += ["--critic_ckpt", args.critic_ckpt]
    if args.device:
        cmd += ["--device", args.device]
    print(f"[compare] {' '.join(cmd)}", flush=True)
    # the loop imports this checkout's package from whatever directory the
    # caller runs in, as the script's path does for the JAX loop
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO_ROOT), env.get("PYTHONPATH")) if p)
    subprocess.run(cmd, check=True, env=env)
    return json.loads((out_dir / "summary.json").read_text())


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out_dir = Path(args.out_dir)
    base = design_loop(args.baseline_dir, out_dir / "baseline", args)
    fine = design_loop(args.finetuned_dir, out_dir / "finetuned", args)

    deltas = {
        k: (fine[k] - base[k])
        for k in base
        if isinstance(base.get(k), (int, float)) and isinstance(fine.get(k), (int, float))
    }
    report = {"baseline": base, "finetuned": fine, "deltas": deltas}
    (out_dir / "comparison.json").write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


__all__ = ["design_loop", "main", "parser"]


if __name__ == "__main__":
    raise SystemExit(main())
