"""K-mer gradient-boosting DNA baseline (twin of
``scripts/benchmark_xgboost_dna.py``, the same flags).

    python -m genomics_lm_torch.evals.benchmark_xgboost_dna --train_csv train.csv \
        --test_csv test.csv [--k 3] [--out outputs/probes/xgboost_dna.json]

Both CSVs hold ``id,sequence,label`` with any number of integer classes.
The k-mers are TF-IDF weighted (``evals/probes.py::_tfidf``). Where xgboost
imports, ``fit_kmer_xgb`` fits its booster, as the JAX script does. Where it
does not, the port's histogram booster (``evals/hist_gbdt.py``, sklearn's
``HistGradientBoostingClassifier(max_iter=200)`` arithmetic) fits the dense
TF-IDF matrix in place of sklearn's. The report holds the ``engine``, ``k``
and the test metrics with bootstrap CIs (``evals/metrics.py``).
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

PORT_ENGINE = "port_hist_gbdt (xgboost not installed)"


def read_labelled(path):
    import numpy as np

    seqs, labels = [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            seqs.append(row["sequence"])
            labels.append(int(row["label"]))
    return seqs, np.asarray(labels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train_csv", required=True, help="id,sequence,label")
    ap.add_argument("--test_csv", required=True)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--out", default="outputs/probes/xgboost_dna.json")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.hist_gbdt import HistGradientBoostingClassifier
    from genomics_lm_torch.evals.metrics import compute_metrics
    from genomics_lm_torch.evals.probes import _tfidf, fit_kmer_xgb

    train_seqs, y_tr = read_labelled(args.train_csv)
    test_seqs, y_te = read_labelled(args.test_csv)
    try:
        fitted = fit_kmer_xgb(train_seqs, y_tr, k=args.k)
        clf, X_te, engine = fitted.model, fitted.vectorizer.transform(test_seqs), "xgboost"
    except RuntimeError as exc:
        if not isinstance(exc.__cause__, ImportError):  # only a missing xgboost falls back
            raise
        vec = _tfidf(args.k, True)
        X_tr = vec.fit_transform(train_seqs).toarray()
        X_te = vec.transform(test_seqs).toarray()
        clf = HistGradientBoostingClassifier(max_iter=200).fit(X_tr, y_tr)
        engine = PORT_ENGINE
    metrics = compute_metrics(y_te, clf.predict(X_te), clf.predict_proba(X_te), bootstrap=True)
    report = {"engine": engine, "k": args.k, "test_metrics": metrics}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
