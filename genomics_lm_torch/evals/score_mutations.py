"""Per-position Δlog-P mutation scoring of one CDS under a trained run (twin
of ``scripts/score_mutations.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.score_mutations <run_id> --dna ATG... [--out m.tsv] \
        [--checkpoint best.npz] [--device cpu]

``--dna`` is a DNA string or a file (raw or FASTA). Writes the TSV of
``evals/mutations.py::score_mutations`` (default
``<run>/scores/mutation_scores.tsv``).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def read_dna(arg: str) -> str:
    path = Path(arg)
    if path.exists():
        text = path.read_text()
        if text.lstrip().startswith(">"):
            return "".join(
                line.strip() for line in text.splitlines() if not line.startswith(">")
            )
        return "".join(text.split())
    return arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--dna", required=True, help="DNA string or file (raw/FASTA)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.mutations import score_mutations, write_mutation_tsv
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, _, _ = load_codon_model(run_dir, args.checkpoint, device=args.device)
    rows = score_mutations(model, cfg.replace(dropout=0.0), read_dna(args.dna))
    out = Path(args.out) if args.out else run_dir / "scores" / "mutation_scores.tsv"
    write_mutation_tsv(rows, out)
    print(f"[mutations] wrote {len(rows)} positions → {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
