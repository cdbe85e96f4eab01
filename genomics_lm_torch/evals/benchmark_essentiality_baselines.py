"""Gene-essentiality baselines beside the CodonLM representation probe (twin
of ``scripts/benchmark_essentiality_baselines.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.evals.benchmark_essentiality_baselines [run_id] \\
        --genes_csv genes.csv [--folds 5] [--seed 0] [--pooling mean_nonpad] \\
        [--out outputs/probes/essentiality_baselines.json] [--run_root runs] \\
        [--device cpu]

Columns, each over one ``StratifiedKFold(folds, shuffle, seed)``: logistic
regression (``max_iter`` 2000) and histogram gradient boosting
(``evals/hist_gbdt.py``, ``max_iter`` 150) on the 64 codon frequencies, and
with a run the logistic regression on its pooled embeddings (the flash
forward on the card). Each reports mean and spread of F1 and mean accuracy.
Input CSV columns: ``sequence`` (or ``dna``) and ``essential`` (or
``label``). The estimators are the port's own (``evals/estimators.py``).
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np

CODONS = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"]


def codon_frequency_features(seqs) -> np.ndarray:
    """(N, 64) float32 frequencies of the 64 codons of each in-frame CDS."""
    index = {c: i for i, c in enumerate(CODONS)}
    X = np.zeros((len(seqs), 64), np.float32)
    for row, dna in enumerate(seqs):
        dna = dna.upper().replace("U", "T")
        n = 0
        for i in range(0, (len(dna) // 3) * 3, 3):
            j = index.get(dna[i : i + 3])
            if j is not None:
                X[row, j] += 1
                n += 1
        if n:
            X[row] /= n
    return X


def baselines_report(feature_sets: dict, y: np.ndarray, folds: int, seed: int) -> dict:
    """F1 and accuracy of each (features, model) column over the same folds."""
    from genomics_lm_torch.evals.estimators import LogisticRegression, StratifiedKFold, f1_score
    from genomics_lm_torch.evals.hist_gbdt import HistGradientBoostingClassifier

    # the booster's early-stopping rows (above 10,000 genes) come from the seed; the
    # script's sklearn booster draws them unseeded
    models = {"logreg": lambda: LogisticRegression(max_iter=2000),
              "gbdt": lambda: HistGradientBoostingClassifier(max_iter=150, random_state=seed)}
    columns = {"codon_freq_logreg": ("codon_freq", "logreg"),
               "codon_freq_gbdt": ("codon_freq", "gbdt")}
    if "lm_embedding" in feature_sets:
        columns["lm_embedding_logreg"] = ("lm_embedding", "logreg")
    splitter = StratifiedKFold(n_splits=folds, shuffle=True, random_state=seed)
    report = {}
    for name, (feats, model_name) in columns.items():
        X = feature_sets[feats]
        f1s, accs = [], []
        for train_index, test_index in splitter.split(X, y):
            model = models[model_name]()
            model.fit(X[train_index], y[train_index])
            pred = model.predict(X[test_index])
            f1s.append(f1_score(y[test_index], pred))
            accs.append(float((pred == y[test_index]).mean()))
        report[name] = {"mean_f1": float(np.mean(f1s)), "std_f1": float(np.std(f1s)),
                        "mean_accuracy": float(np.mean(accs))}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id", nargs="?", default=None,
                    help="optional run for the LM-embedding probe column")
    ap.add_argument("--genes_csv", required=True, help="gene,sequence,essential")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pooling", default="mean_nonpad")
    ap.add_argument("--out", default="outputs/probes/essentiality_baselines.json")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    seqs, labels = [], []
    with open(args.genes_csv) as f:
        for row in csv.DictReader(f):
            seq = row.get("sequence") or row.get("dna")
            label = row.get("essential") or row.get("label")
            if seq and label is not None:
                seqs.append(seq)
                labels.append(int(label))
    y = np.asarray(labels)

    feature_sets = {"codon_freq": codon_frequency_features(seqs)}
    if args.run_id:
        from genomics_lm_torch.evals.benchmark_gene_essentiality import lm_embeddings
        from genomics_lm_torch.utils.cli import resolve_run_dir

        feature_sets["lm_embedding"] = lm_embeddings(
            resolve_run_dir(args.run_id, args.run_root), seqs, args.pooling, args.device)
    report = baselines_report(feature_sets, y, args.folds, args.seed)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
