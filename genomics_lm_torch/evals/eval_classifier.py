"""Evaluate a saved (pickled) classifier on embeddings or sequences (twin of
``scripts/eval_classifier.py``, the same flags).

    python -m genomics_lm_torch.evals.eval_classifier --kind probe|kmer \
        --model model.pkl [--embeddings emb.npz | --vectorizer vec.pkl --seqs seqs.csv] \
        --labels labels.csv [--out dir]

Metrics with bootstrap CIs from ``evals/metrics.py`` into
``<out>/metrics.json``. Host-only: the model and the vectorizer are pickles
of the port's estimators (``evals/estimators.py``: ``Pipeline``,
``LogisticRegression``, ``LinearSVC``, ``TfidfVectorizer``), as
``train_classifier`` writes them; a sklearn pickle written by the JAX
package needs sklearn to load and is not a contract of the port.
"""

from __future__ import annotations

import argparse
import csv
import json
import pickle
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["probe", "kmer"], required=True)
    ap.add_argument("--model", required=True, help="pickled classifier")
    ap.add_argument("--embeddings", default=None, help="NPZ {X, ids} (probe kind)")
    ap.add_argument("--vectorizer", default=None, help="pickled vectorizer (kmer)")
    ap.add_argument("--seqs", default=None, help="CSV id,sequence (kmer kind)")
    ap.add_argument("--labels", required=True, help="CSV id,label")
    ap.add_argument("--out", default="outputs/reports/eval_classifier")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.metrics import compute_metrics

    with open(args.model, "rb") as f:
        model = pickle.load(f)

    labels = {}
    with open(args.labels) as f:
        for row in csv.DictReader(f):
            if row.get("id") and row.get("label") is not None:
                labels[row["id"]] = int(row["label"])

    if args.kind == "probe":
        if not args.embeddings:
            raise SystemExit("--embeddings required for kind=probe")
        with np.load(args.embeddings, allow_pickle=True) as z:
            X_all = np.asarray(z["X"])
            ids = [str(i) for i in z["ids"]]
    else:
        if not (args.vectorizer and args.seqs):
            raise SystemExit("--vectorizer and --seqs required for kind=kmer")
        with open(args.vectorizer, "rb") as f:
            vectorizer = pickle.load(f)
        ids, seqs = [], []
        with open(args.seqs) as f:
            for row in csv.DictReader(f):
                seq = row.get("sequence") or row.get("dna")
                if row.get("id") and seq:
                    ids.append(row["id"])
                    seqs.append(seq)
        X_all = vectorizer.transform(seqs)

    keep = [i for i, ident in enumerate(ids) if ident in labels]
    if not keep:
        raise SystemExit("no ids with labels")
    X = X_all[keep]
    y = np.asarray([labels[ids[i]] for i in keep])
    y_pred = model.predict(X)
    try:
        y_proba = model.predict_proba(X)
    except Exception:
        try:
            y_proba = model.decision_function(X)
        except Exception:
            y_proba = None
    metrics = compute_metrics(y, y_pred, y_proba, bootstrap=True)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "metrics.json").write_text(json.dumps(metrics, indent=2) + "\n")
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
