"""Chou–Fasman-style secondary-structure propensities of CDS-derived
proteins (twin of ``scripts/ss_propensity.py``, the same flags).

    python -m genomics_lm_torch.evals.ss_propensity (--dna cds.txt | --protein aa.txt) \\
        [--window 6] [--out outputs/ss_propensity/ss_propensity.json]

Each protein (a CDS translated by ``data/leakage.py::translate_cds``, the
stop removed; an untranslatable line skipped) gets a per-residue H/E/C
string from windowed mean helix and sheet propensities; the JSON holds the
mean helix and sheet fractions and every sequence's fractions, the CSV
beside it the per-sequence rows. Host only.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np

# Chou–Fasman conformational propensities (helix Pa, sheet Pb)
CF = {
    "A": (1.42, 0.83), "R": (0.98, 0.93), "N": (0.67, 0.89), "D": (1.01, 0.54),
    "C": (0.70, 1.19), "Q": (1.11, 1.10), "E": (1.51, 0.37), "G": (0.57, 0.75),
    "H": (1.00, 0.87), "I": (1.08, 1.60), "L": (1.21, 1.30), "K": (1.16, 0.74),
    "M": (1.45, 1.05), "F": (1.13, 1.38), "P": (0.57, 0.55), "S": (0.77, 0.75),
    "T": (0.83, 1.19), "W": (1.08, 1.37), "Y": (0.69, 1.47), "V": (1.06, 1.70),
}


def classify(seq: str, window: int = 6) -> str:
    """Per-residue H/E/C string from windowed mean propensities."""
    if not seq:
        return ""
    pa = [CF.get(a, (1.0, 1.0))[0] for a in seq]
    pb = [CF.get(a, (1.0, 1.0))[1] for a in seq]
    out = []
    half = window // 2
    for i in range(len(seq)):
        lo, hi = max(0, i - half), min(len(seq), i + half + 1)
        mean_a = sum(pa[lo:hi]) / (hi - lo)
        mean_b = sum(pb[lo:hi]) / (hi - lo)
        if mean_a > 1.03 and mean_a > mean_b:
            out.append("H")
        elif mean_b > 1.05 and mean_b > mean_a:
            out.append("E")
        else:
            out.append("C")
    return "".join(out)


def read_proteins(dna_path: str | None, protein_path: str | None) -> list[str]:
    """Proteins from one-CDS-a-line DNA (translated, the stop removed, an
    untranslatable line skipped) or from one-protein-a-line text."""
    if dna_path:
        from genomics_lm_torch.data.leakage import translate_cds

        proteins = []
        for dna in Path(dna_path).read_text().splitlines():
            if not dna.strip():
                continue
            try:
                proteins.append(translate_cds(dna.strip()).rstrip("*"))
            except Exception:  # the script skips any line it cannot translate
                continue
        return proteins
    return [line.strip() for line in Path(protein_path).read_text().splitlines()
            if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--dna", help="one DNA CDS per line")
    group.add_argument("--protein", help="one protein sequence per line")
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--out", default="outputs/ss_propensity/ss_propensity.json")
    args = ap.parse_args(argv)

    proteins = read_proteins(args.dna, args.protein)
    rows, h_frac, e_frac = [], [], []
    for i, seq in enumerate(proteins):
        ss = classify(seq, args.window)
        h = ss.count("H") / max(len(ss), 1)
        e = ss.count("E") / max(len(ss), 1)
        h_frac.append(h)
        e_frac.append(e)
        rows.append({"index": i, "length": len(seq), "helix_frac": round(h, 4),
                     "sheet_frac": round(e, 4), "coil_frac": round(1 - h - e, 4)})

    report = {
        "sequences": len(rows),
        "mean_helix_frac": float(np.mean(h_frac)) if h_frac else None,
        "mean_sheet_frac": float(np.mean(e_frac)) if e_frac else None,
        "per_sequence": rows,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    with out.with_suffix(".csv").open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["index", "length", "helix_frac",
                                               "sheet_frac", "coil_frac"])
        writer.writeheader()
        writer.writerows(rows)
    print(json.dumps({k: v for k, v in report.items() if k != "per_sequence"}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
