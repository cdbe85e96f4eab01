"""YAML-driven downstream classifier harness over embeddings or sequences
(twin of ``scripts/train_classifier.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.train_classifier --config probe.yaml \
        [--out_dir dir] [--device cpu]

Kinds ``probe_logreg | probe_svm | mlp | kmer_logreg | kmer_svm | kmer_xgb``
(the ``mlp`` kind trains ``evals/probes.py::fit_mlp`` on ``--device``, the
others fit on the host with the port's estimators, ``evals/estimators.py``;
``kmer_xgb`` needs xgboost, as in the JAX package), protocols ``std``, ``TSTR``
(train-synthetic, test-real) and ``TRTS`` (train-real, test-synthetic).
The two packs are bound first (``evals/provenance.py::bind_embedding_pair``;
``require_verified_provenance: true`` fails closed on a pack without a
verified sidecar or on a dataset, weights or vocabulary mismatch). Writes
``metrics.json`` (bootstrap CIs), the pickled model (the port's
``Pipeline``, ``LogisticRegression`` or ``LinearSVC``) and a confusion plot
where matplotlib imports.
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path


KINDS = ("probe_logreg", "probe_svm", "mlp", "kmer_logreg", "kmer_svm", "kmer_xgb")
PROTOCOLS = ("std", "TSTR", "TRTS")


def load_pack(path):
    import numpy as np

    with np.load(path, allow_pickle=True) as blob:
        X = blob["X"]
        y = blob["y"] if "y" in blob else None
        ids = blob["ids"] if "ids" in blob else None
        seqs = blob["sequences"] if "sequences" in blob else None
    return X, y, ids, seqs


def load_labels(path, ids):
    import csv

    import numpy as np

    label_of = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            key = row.get("id") or row.get("source_id")
            label_of[key] = int(row.get("label") or row.get("y"))
    return np.asarray([label_of[str(i)] for i in ids])


def fit(kind: str, X, y, seqs, cfg: dict, device=None):
    from genomics_lm_torch.evals import probes

    if kind == "probe_logreg":
        return probes.fit_logreg(X, y, C=float(cfg.get("C", 1.0)))
    if kind == "probe_svm":
        return probes.fit_linear_svm(X, y, C=float(cfg.get("C", 1.0)))
    if kind == "mlp":
        return probes.fit_mlp(
            X, y,
            epochs=int(cfg.get("epochs", 20)),
            hidden=int(cfg.get("hidden", 128)),
            depth=int(cfg.get("depth", 1)),
            lr=float(cfg.get("lr", 1e-3)),
            device=device,
        )
    if kind in {"kmer_logreg", "kmer_svm", "kmer_xgb"}:
        if seqs is None:
            raise ValueError(f"{kind} requires sequences in the input pack")
        k = int(cfg.get("k", 3))
        if kind == "kmer_logreg":
            return probes.fit_kmer_logreg(list(seqs), y, k=k)
        if kind == "kmer_svm":
            return probes.fit_kmer_svm(list(seqs), y, k=k)
        return probes.fit_kmer_xgb(list(seqs), y, k=k)
    raise ValueError(f"unknown kind {kind!r}; choose from {KINDS}")


def evaluate(result, kind, X, y, seqs):
    import numpy as np

    from genomics_lm_torch.evals.metrics import compute_metrics

    if kind.startswith("kmer"):
        Xv = result.vectorizer.transform(list(seqs))
        y_pred = result.model.predict(Xv)
        try:
            y_proba = result.model.predict_proba(Xv)
        except Exception:
            try:
                y_proba = result.model.decision_function(Xv)
            except Exception:
                y_proba = None
    elif kind == "mlp":
        y_pred, y_proba = result.predict_fn(X)
    else:
        y_pred = result.model.predict(X)
        try:
            y_proba = result.model.predict_proba(X)
        except Exception:
            y_proba = None
    return compute_metrics(np.asarray(y), np.asarray(y_pred), y_proba, bootstrap=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="YAML probe config")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the mlp kind (default: the CUDA card)")
    args = ap.parse_args(argv)

    import yaml

    cfg = yaml.safe_load(Path(args.config).read_text()) or {}
    kind = cfg.get("kind", "probe_logreg")
    protocol = cfg.get("protocol", "std")
    if protocol not in PROTOCOLS:
        raise ValueError(f"protocol must be one of {PROTOCOLS}")

    # Embedding-pair binding: verified mode fails closed on any dataset /
    # model / vocabulary mismatch between the two packs (evals.provenance).
    from genomics_lm_torch.evals.provenance import bind_embedding_pair

    provenance = bind_embedding_pair(
        cfg["train_npz"], cfg["test_npz"],
        require_verified=bool(cfg.get("require_verified_provenance", False)),
    )

    X_tr, y_tr, ids_tr, seq_tr = load_pack(cfg["train_npz"])
    X_te, y_te, ids_te, seq_te = load_pack(cfg["test_npz"])
    if y_tr is None:
        y_tr = load_labels(cfg["train_labels"], ids_tr)
    if y_te is None:
        y_te = load_labels(cfg["test_labels"], ids_te)
    if protocol == "TSTR":
        pass  # train pack is the synthetic set by convention
    elif protocol == "TRTS":
        (X_tr, y_tr, seq_tr), (X_te, y_te, seq_te) = (
            (X_te, y_te, seq_te), (X_tr, y_tr, seq_tr),
        )

    result = fit(kind, X_tr, y_tr, seq_tr, cfg, args.device)
    test_metrics = evaluate(result, kind, X_te, y_te, seq_te)

    out_dir = Path(args.out_dir or cfg.get("out_dir", "outputs/classifiers"))
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {
        "kind": kind,
        "protocol": protocol,
        "train_metrics": result.metrics,
        "test_metrics": test_metrics,
        "n_train": int(len(y_tr)),
        "n_test": int(len(y_te)),
        "provenance": {
            "train": provenance["train"]["status"],
            "test": provenance["test"]["status"],
        },
    }
    (out_dir / "metrics.json").write_text(json.dumps(report, indent=2) + "\n")
    if kind != "mlp":
        with (out_dir / "model.pkl").open("wb") as f:
            pickle.dump(getattr(result, "model", None), f)
    try:
        import numpy as np

        from genomics_lm_torch.evals.metrics import plot_confusion

        if kind.startswith("kmer"):
            Xv = result.vectorizer.transform(list(seq_te))
            y_pred = result.model.predict(Xv)
        elif kind == "mlp":
            y_pred, _ = result.predict_fn(X_te)
        else:
            y_pred = result.model.predict(X_te)
        plot_confusion(np.asarray(y_te), np.asarray(y_pred), out_dir / "confusion.png")
    except Exception as exc:
        print(f"[warn] confusion plot failed: {exc}")
    print(json.dumps(test_metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
