"""Token-level linear probe for secondary structure H/E/C (twin of
``scripts/probe_ss_linear.py``, the same flags).

    python -m genomics_lm_torch.evals.probe_ss_linear --emb_npz tokens.npz \
        [--test_fraction 0.25] [--C 1.0] [--seed 0] [--out_dir outputs/probes/ss_linear]

The NPZ holds ``H`` (N, T, D) per-token hidden states, ``Y`` (N, T) labels
0/1/2 for C/H/E and an optional validity mask ``M`` (N, T). The split is
made at the sequence level (``train_test_split`` of the sequence indices),
so one chain's tokens never cross folds; a ``LogisticRegression(max_iter=
2000, C)`` is fitted on the masked training tokens with the port's
estimators (``evals/estimators.py``). ``<out_dir>/metrics.json`` holds the
token accuracy, the majority baseline, each class's support and recall, the
confusion matrix and the token counts; ``confusion.png`` is skipped with a
printed line where matplotlib does not import.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

LABELS = ["C", "H", "E"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--emb_npz", required=True,
                    help="NPZ with H (N,T,D), Y (N,T), optional M (N,T)")
    ap.add_argument("--test_fraction", type=float, default=0.25)
    ap.add_argument("--C", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default="outputs/probes/ss_linear")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.estimators import (
        LogisticRegression,
        confusion_matrix,
        train_test_split,
    )

    with np.load(args.emb_npz) as z:
        H = np.asarray(z["H"], np.float32)
        Y = np.asarray(z["Y"], np.int64)
        M = np.asarray(z["M"]) if "M" in z.files else np.ones(Y.shape, np.int64)

    idx_train, idx_test = train_test_split(np.arange(len(H)), test_size=args.test_fraction,
                                           random_state=args.seed)

    def flatten(idx):
        mask = M[idx].reshape(-1).astype(bool)
        return H[idx].reshape(-1, H.shape[-1])[mask], Y[idx].reshape(-1)[mask]

    X_tr, y_tr = flatten(idx_train)
    X_te, y_te = flatten(idx_test)
    model = LogisticRegression(max_iter=2000, C=args.C).fit(X_tr, y_tr)
    y_pred = model.predict(X_te)

    cm = confusion_matrix(y_te, y_pred, labels=list(range(len(LABELS))))
    per_class = {}
    for i, name in enumerate(LABELS):
        support = int(cm[i].sum())
        per_class[name] = {"support": support,
                           "recall": float(cm[i, i] / support) if support else None}
    report = {
        "token_accuracy": float((y_pred == y_te).mean()),
        "majority_baseline": float(np.bincount(y_te).max() / len(y_te)),
        "per_class": per_class,
        "confusion": cm.tolist(),
        "train_tokens": int(len(y_tr)),
        "test_tokens": int(len(y_te)),
    }
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "metrics.json").write_text(json.dumps(report, indent=2) + "\n")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(4, 3.5))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(LABELS)), LABELS)
        ax.set_yticks(range(len(LABELS)), LABELS)
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        for i in range(len(LABELS)):
            for j in range(len(LABELS)):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center", fontsize=8)
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(out_dir / "confusion.png", dpi=120)
        plt.close(fig)
    except Exception as exc:
        print(f"[probe] confusion plot skipped: {exc}")
    print(json.dumps({k: v for k, v in report.items() if k != "confusion"}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
