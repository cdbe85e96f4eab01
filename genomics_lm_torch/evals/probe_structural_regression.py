"""DNA-shape structural regression probe (twin of
``scripts/probe_structural_regression.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.probe_structural_regression <run_id> \\
        [--n_sequences 64] [--seq_len_codons 48] [--seed 0] [--out regression.json] \\
        [--run_root runs] [--device cpu]

Uniform random CDS of ``min(seq_len_codons, block - 1)`` codons, each
through ``forward_hidden`` at batch 1 (the flash forward on the card); the
per-codon MGW/Roll/EP means regressed from the codon positions' hidden
states by ``Ridge(alpha=1)`` on one 75/25 ``train_test_split``
(``evals/estimators.py``): R² and Spearman ρ (scipy) a parameter and their
averages. Writes ``--out`` (default ``<run>/scores/structural_regression.json``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--n_sequences", type=int, default=64)
    ap.add_argument("--seq_len_codons", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from scipy import stats

    from genomics_lm_torch.evals.estimators import train_test_split
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.evals.probe_structural_awareness import codon_hidden, ridge_r2
    from genomics_lm_torch.models.biophysics import get_theoretical_shape
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, _, _ = load_codon_model(run_dir, device=args.device)
    cfg = cfg.replace(dropout=0.0)
    rng = np.random.default_rng(args.seed)

    L = min(args.seq_len_codons, cfg.block_size - 1)
    features, targets = [], []
    for _ in range(args.n_sequences):
        dna = "".join(rng.choice(list("ACGT"), 3 * L))
        features.append(codon_hidden(model, cfg, dna))
        shapes = get_theoretical_shape(dna)
        per_nt = np.stack([shapes["MGW"], shapes["Roll"], shapes["EP"]], axis=-1)
        targets.append(per_nt.reshape(L, 3, 3).mean(axis=1))
    X = np.concatenate(features)
    Y = np.concatenate(targets)

    X_tr, X_te, Y_tr, Y_te = train_test_split(X, Y, test_size=0.25, random_state=args.seed)
    report = {}
    r2s, rhos = [], []
    for i, name in enumerate(("MGW", "Roll", "EP")):
        pred, ss_res, ss_tot = ridge_r2(X_tr, X_te, Y_tr[:, i], Y_te[:, i])
        r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
        rho = float(stats.spearmanr(pred, Y_te[:, i]).statistic)
        report[name] = {"r2": r2, "spearman_rho": rho}
        r2s.append(r2)
        rhos.append(rho)
    report["avg"] = {"r2": float(np.mean(r2s)), "spearman_rho": float(np.mean(rhos))}
    out = Path(args.out) if args.out else run_dir / "scores" / "structural_regression.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
