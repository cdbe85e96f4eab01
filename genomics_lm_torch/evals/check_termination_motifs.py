"""Check whether terminal regions carry structural termination cues (twin of
``scripts/check_termination_motifs.py``, the same flags).

    python -m genomics_lm_torch.evals.check_termination_motifs --dna cds.txt \
        [--generated candidates.csv] [--window 30] [--seed 0] [--out report.json]

GC-hairpin and poly-T scores in the window at the stop codon against a
random interior window, on real and optionally generated CDS (lines, or a
CSV with a ``dna``/``sequence`` column). Host-only: no model runs.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def read_sequences(path: Path) -> list[str]:
    import csv

    text = path.read_text()
    first = text.splitlines()[0] if text.splitlines() else ""
    if "," in first and not set(first.strip()) <= set("ACGTN,"):
        seqs = []
        with path.open() as f:
            for row in csv.DictReader(f):
                seq = row.get("dna") or row.get("sequence")
                if seq:
                    seqs.append(seq)
        return seqs
    return [l.strip() for l in text.splitlines() if l.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dna", required=True, help="CDS lines or CSV")
    ap.add_argument("--generated", default=None,
                    help="optional generated set for comparison")
    ap.add_argument("--window", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="outputs/termination/termination_motifs.json")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.termination_motifs import terminal_window_contrast

    report = {
        "window": args.window,
        "real": terminal_window_contrast(
            read_sequences(Path(args.dna)), window=args.window, seed=args.seed
        ),
    }
    if args.generated:
        report["generated"] = terminal_window_contrast(
            read_sequences(Path(args.generated)), window=args.window,
            seed=args.seed,
        )
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
