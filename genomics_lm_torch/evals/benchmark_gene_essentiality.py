"""Gene-essentiality probe benchmark (twin of
``scripts/benchmark_gene_essentiality.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.benchmark_gene_essentiality <run_id> \\
        --genes_csv genes.csv [--pooling mean_nonpad] [--folds 5] [--seed 0] \\
        [--out essentiality.json] [--run_root runs] [--device cpu]

Per-gene embeddings (``extract_embeddings`` in batches of 64: the flash
forward on the card) → a standardized, class-balanced logistic regression
(``evals/estimators.py``, sklearn's arithmetic without sklearn) over
``StratifiedKFold(min(folds, minority count))``; the report holds the genes,
the positive fraction, the folds and the F1 mean and spread. Input CSV
columns: ``id``, ``sequence`` (CDS DNA), ``essential`` (0/1). Writes
``--out`` (default ``<run>/scores/essentiality_benchmark.json``).
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np


def lm_embeddings(run_dir, seqs: list[str], pooling: str, device=None) -> np.ndarray:
    """The run's pooled embeddings of ``seqs`` (one block-wide row a CDS)."""
    from genomics_lm_torch.evals.embeddings import extract_embeddings, ids_from_dna
    from genomics_lm_torch.evals.playground import load_codon_model

    model, cfg, _, _ = load_codon_model(run_dir, device=device)
    cfg = cfg.replace(dropout=0.0)
    rows = np.stack([ids_from_dna(s, cfg.block_size) for s in seqs])
    return extract_embeddings(model, cfg, rows, mode=pooling)


def essentiality_report(X: np.ndarray, y: np.ndarray, folds: int, seed: int) -> dict:
    """Cross-validated F1 of the balanced logistic probe on ``X``."""
    from genomics_lm_torch.evals.estimators import (
        StandardizedLogisticRegression,
        StratifiedKFold,
        f1_score,
    )

    skf = StratifiedKFold(n_splits=min(folds, int(np.bincount(y).min())), shuffle=True,
                          random_state=seed)
    f1s = []
    for train_idx, test_idx in skf.split(X, y):
        clf = StandardizedLogisticRegression(max_iter=2000, class_weight="balanced")
        clf.fit(X[train_idx], y[train_idx])
        f1s.append(f1_score(y[test_idx], clf.predict(X[test_idx])))
    return {"n_genes": len(y), "positive_fraction": float(y.mean()), "folds": len(f1s),
            "f1_mean": float(np.mean(f1s)), "f1_std": float(np.std(f1s))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--genes_csv", required=True)
    ap.add_argument("--pooling", default="mean_nonpad")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    seqs, labels = [], []
    with open(args.genes_csv) as f:
        for row in csv.DictReader(f):
            seqs.append(row["sequence"])
            labels.append(int(row["essential"]))
    y = np.asarray(labels)
    X = lm_embeddings(run_dir, seqs, args.pooling, args.device)
    report = essentiality_report(X, y, args.folds, args.seed)
    out = Path(args.out) if args.out else run_dir / "scores" / "essentiality_benchmark.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
