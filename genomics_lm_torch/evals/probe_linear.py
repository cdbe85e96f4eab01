"""Linear probe over embedding packs (twin of ``scripts/probe_linear.py``,
the same flags).

    python -m genomics_lm_torch.evals.probe_linear --train_npz train.npz \
        --test_npz test.npz [--train_labels ids.csv --test_labels ids.csv] \
        [--kind logreg|svm] [--C 1.0] [--out linear_probe.json]

StandardScaler + LogisticRegression or LinearSVC (the port's estimators,
``evals/estimators.py``, on the host), test metrics with bootstrap CIs from ``evals/metrics.py``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_npz", required=True, help="NPZ with X (+ y or ids)")
    ap.add_argument("--test_npz", required=True)
    ap.add_argument("--train_labels", default=None, help="CSV id,label when y absent")
    ap.add_argument("--test_labels", default=None)
    ap.add_argument("--kind", choices=["logreg", "svm"], default="logreg")
    ap.add_argument("--C", type=float, default=1.0)
    ap.add_argument("--out", default="outputs/probes/linear_probe.json")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.metrics import compute_metrics
    from genomics_lm_torch.evals.probes import fit_linear_svm, fit_logreg
    from genomics_lm_torch.evals.train_classifier import load_labels, load_pack

    X_tr, y_tr, ids_tr, _ = load_pack(args.train_npz)
    X_te, y_te, ids_te, _ = load_pack(args.test_npz)
    if y_tr is None:
        y_tr = load_labels(args.train_labels, ids_tr)
    if y_te is None:
        y_te = load_labels(args.test_labels, ids_te)

    fit = fit_logreg if args.kind == "logreg" else fit_linear_svm
    result = fit(X_tr, y_tr, C=args.C)
    y_pred = result.model.predict(X_te)
    try:
        y_proba = result.model.predict_proba(X_te)
    except Exception:
        try:
            y_proba = result.model.decision_function(X_te)
        except Exception:
            y_proba = None
    test_metrics = compute_metrics(np.asarray(y_te), y_pred, y_proba, bootstrap=True)
    report = {"kind": args.kind, "train_metrics": result.metrics,
              "test_metrics": test_metrics}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(test_metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
