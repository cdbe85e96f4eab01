"""DNA-shape regression baselines (twin of ``scripts/eval_shape_baselines.py``,
the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.eval_shape_baselines [run_id] \\
        [--n_sequences 64] [--seq_len_codons 32] [--seed 0] \\
        [--out outputs/probes/shape_baselines.json] [--run_root runs] [--device cpu]

Motif-biased random CDS (seeded numpy); the per-codon MGW/Roll/EP means
regressed by ``Ridge(alpha=1)`` on one 75/25 ``train_test_split``
(``evals/estimators.py``) from three feature sets: the codon-local one-hot
(12 columns), the dinucleotide counts of each codon (16), and with a run the
codon positions' hidden states (``forward_hidden`` at batch 1: the flash
forward on the card). Each reports the mean R² and Spearman ρ (scipy) over
the targets that vary on the held-out rows.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

MOTIFS = ["AAAA", "GGGG", "CCCC", "GGCC", "TTTT", ""]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id", nargs="?", default=None,
                    help="optional run for the LM-feature column")
    ap.add_argument("--n_sequences", type=int, default=64)
    ap.add_argument("--seq_len_codons", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="outputs/probes/shape_baselines.json")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from scipy import stats

    from genomics_lm_torch.evals.estimators import train_test_split
    from genomics_lm_torch.evals.probe_structural_awareness import motif_biased_dna, ridge_r2
    from genomics_lm_torch.models.biophysics import get_theoretical_shape, one_hot_dna

    rng = np.random.default_rng(args.seed)
    L = args.seq_len_codons
    onehots, kmers, targets, dnas = [], [], [], []
    for _ in range(args.n_sequences):
        dna = motif_biased_dna(rng, L, MOTIFS)
        dnas.append(dna)
        onehots.append(one_hot_dna(dna).reshape(L, 12))  # codon-local one-hot
        counts = np.zeros((L, 16), np.float32)  # dinucleotide counts per codon
        for c in range(L):
            tri = dna[3 * c : 3 * c + 3]
            for j in range(2):
                di = tri[j : j + 2]
                counts[c, "ACGT".index(di[0]) * 4 + "ACGT".index(di[1])] += 1
        kmers.append(counts)
        shapes = get_theoretical_shape(dna)
        nt = np.stack([shapes["MGW"], shapes["Roll"], shapes["EP"]], axis=-1)
        targets.append(nt.reshape(L, 3, 3).mean(axis=1))
    Y = np.concatenate(targets)

    feature_sets = {"onehot_codon": np.concatenate(onehots),
                    "dinucleotide_counts": np.concatenate(kmers)}
    if args.run_id:
        from genomics_lm_torch.evals.playground import load_codon_model
        from genomics_lm_torch.evals.probe_structural_awareness import codon_hidden
        from genomics_lm_torch.utils.cli import resolve_run_dir

        model, cfg, _, _ = load_codon_model(resolve_run_dir(args.run_id, args.run_root),
                                            device=args.device)
        cfg = cfg.replace(dropout=0.0)
        feature_sets["lm_hidden"] = np.concatenate([codon_hidden(model, cfg, d) for d in dnas])

    report = {}
    for name, X in feature_sets.items():
        X_tr, X_te, Y_tr, Y_te = train_test_split(X, Y, test_size=0.25, random_state=args.seed)
        r2s, rhos = [], []
        for i in range(3):
            if float(Y_te[:, i].std()) < 1e-9:  # constant target: R2 undefined
                continue
            pred, ss_res, ss_tot = ridge_r2(X_tr, X_te, Y_tr[:, i], Y_te[:, i])
            r2s.append(1.0 - ss_res / ss_tot)
            rhos.append(float(stats.spearmanr(pred, Y_te[:, i]).statistic))
        report[name] = {"avg_r2": float(np.mean(r2s)) if r2s else None,
                        "avg_spearman": float(np.mean(rhos)) if rhos else None,
                        "n_target_dims_used": len(r2s)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
