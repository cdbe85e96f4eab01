"""Zero-shot mutation-effect benchmark against a deep mutational scan (twin
of ``scripts/benchmark_zero_shot_mutations.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.evals.benchmark_zero_shot_mutations <run_id> \\
        --dna WT_CDS_OR_FILE --dms_csv dms.csv [--out dms_benchmark.json] \\
        [--run_root runs] [--device cpu]

Scores the wild type with ``evals/mutations.py::score_mutations`` (the
flash forward on the card, one a window), reads the DMS table's
``position`` (0-based codon), mutant codon (``mutant_codon``, else
``mut_codon``, else ``mutant``) and ``fitness``, and correlates each
scoreable variant's Δlog-P with its fitness: Spearman and Pearson from
``scipy.stats``. Rows at a position the CDS lacks or with no such codon
are skipped; fewer than 3 scoreable variants end the run. Writes ``--out``
(default ``<run>/scores/dms_benchmark.json``).
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--dna", required=True, help="wild-type CDS (string or file)")
    ap.add_argument("--dms_csv", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from scipy import stats

    from genomics_lm_torch.evals.mutations import score_mutations
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.evals.score_mutations import read_dna
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, _, _ = load_codon_model(run_dir, device=args.device)
    rows = score_mutations(model, cfg.replace(dropout=0.0), read_dna(args.dna))
    by_position = {r["position"]: r for r in rows}

    predicted, measured, skipped = [], [], 0
    with open(args.dms_csv) as f:
        for record in csv.DictReader(f):
            position = int(record["position"])
            mutant = (record.get("mutant_codon") or record.get("mut_codon")
                      or record.get("mutant", "")).upper()
            if position not in by_position or f"delta_{mutant}" not in by_position[position]:
                skipped += 1
                continue
            predicted.append(by_position[position][f"delta_{mutant}"])
            measured.append(float(record["fitness"]))

    if len(predicted) < 3:
        raise SystemExit(f"too few scoreable variants ({len(predicted)}; skipped {skipped})")
    spearman = stats.spearmanr(predicted, measured)
    pearson = stats.pearsonr(predicted, measured)
    report = {
        "n_variants": len(predicted),
        "skipped": skipped,
        "spearman_rho": float(spearman.statistic),
        "spearman_p": float(spearman.pvalue),
        "pearson_r": float(pearson.statistic),
    }
    out = Path(args.out) if args.out else run_dir / "scores" / "dms_benchmark.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
