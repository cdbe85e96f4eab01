"""Select a pooled representation by grouped cross-validation, without the
test set (twin of ``scripts/select_grouped_representation.py``, the same
flags).

    python -m genomics_lm_torch.evals.select_grouped_representation \\
        --embeddings a.npz [b.npz ...] --labels labels.csv --groups groups.csv \\
        [--group_column protein_cluster] [--folds 5] [--seed 42] [--C 1.0] \\
        [--primary_metric macro_auprc] --output selection.json

Accepts multi-representation packs (``X__<name>`` arrays) or single-pooling
packs from ``extract_embeddings`` (``X`` and ``pooling``) sharing one id
order. The ids with a label and a group are split once by
``StratifiedGroupKFold`` (``evals/estimators.py``); every candidate is fitted
on each fold by a standardized logistic regression (the JAX package's
``fit_logreg`` pipeline, ``max_iter`` 2000, built from the port's
estimators) and scored by ``compute_metrics``; the best mean of the primary
metric is selected. Host only.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np


def _mapping(path: Path, value_column: str) -> dict[str, str]:
    with path.open(newline="") as f:
        reader = csv.DictReader(f, delimiter="\t" if path.suffix == ".tsv" else ",")
        return {row["id"]: row[value_column] for row in reader
                if row.get("id") and row.get(value_column)}


def _load(path: Path):
    with np.load(path, allow_pickle=True) as blob:
        ids = [str(v) for v in blob["ids"]]
        arrays = {k.removeprefix("X__"): np.asarray(blob[k])
                  for k in blob.files if k.startswith("X__")}
        if not arrays and "X" in blob.files:
            name = str(blob["pooling"]) if "pooling" in blob.files else path.stem
            arrays = {name: np.asarray(blob["X"])}
    if not arrays:
        raise SystemExit(f"no representation arrays found in {path}")
    return ids, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--embeddings", nargs="+", required=True)
    ap.add_argument("--labels", required=True, help="CSV id,label")
    ap.add_argument("--groups", required=True, help="CSV id,<group column>")
    ap.add_argument("--group_column", default="protein_cluster")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--C", type=float, default=1.0)
    ap.add_argument("--primary_metric", default="macro_auprc")
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.estimators import (
        StandardizedLogisticRegression,
        StratifiedGroupKFold,
    )
    from genomics_lm_torch.evals.metrics import compute_metrics

    labels = _mapping(Path(args.labels), "label")
    groups = _mapping(Path(args.groups), args.group_column)

    loaded = [(Path(p), *_load(Path(p))) for p in args.embeddings]
    reference_ids = loaded[0][1]
    candidates: dict[str, list] = {}
    for path, ids, arrays in loaded:
        if ids != reference_ids:
            raise SystemExit(f"embedding ID order differs: {path}")
        for name, X in arrays.items():
            candidates.setdefault(name, []).append(X)

    keep = [i for i, ident in enumerate(reference_ids) if ident in labels and ident in groups]
    if len(keep) < args.folds:
        raise SystemExit("too few labeled+grouped ids for the requested folds")
    ids = [reference_ids[i] for i in keep]
    to_int = {v: i for i, v in enumerate(sorted({labels[i] for i in ids}))}
    y = np.asarray([to_int[labels[i]] for i in ids])
    group_values = np.asarray([groups[i] for i in ids])
    splitter = StratifiedGroupKFold(n_splits=args.folds, shuffle=True, random_state=args.seed)
    splits = list(splitter.split(np.zeros(len(ids)), y, group_values))

    reports = []
    for name in sorted(candidates):
        fold_scores = []
        for X_full in candidates[name]:
            X = X_full[keep]
            for train_index, val_index in splits:
                model = StandardizedLogisticRegression(C=args.C, max_iter=2000)
                model.fit(X[train_index], y[train_index])
                fold_scores.append(compute_metrics(y[val_index], model.predict(X[val_index]),
                                                   model.predict_proba(X[val_index])))
        primary = [m[args.primary_metric] for m in fold_scores
                   if m.get(args.primary_metric) is not None]
        reports.append({
            "representation": name,
            "folds": len(fold_scores),
            f"mean_{args.primary_metric}": float(np.mean(primary)) if primary else None,
            f"std_{args.primary_metric}": float(np.std(primary)) if primary else None,
        })

    reports.sort(key=lambda r: -(r[f"mean_{args.primary_metric}"] or -1))
    selection = {
        "primary_metric": args.primary_metric,
        "selected": reports[0]["representation"] if reports else None,
        "candidates": reports,
        "n_ids": len(ids),
        "n_groups": int(len(set(group_values.tolist()))),
    }
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(selection, indent=2) + "\n")
    print(json.dumps(selection, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
