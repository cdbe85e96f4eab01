"""Intrinsic-disorder heuristics of CDS-derived proteins (twin of
``scripts/disorder_heuristics.py``, the same flags).

    python -m genomics_lm_torch.evals.disorder_heuristics (--dna cds.txt | --protein aa.txt) \\
        [--out outputs/disorder/disorder_heuristics.json]

Per protein: the Uversky charge–hydropathy call (mean net charge against
``2.785 <H> - 1.151`` of the rescaled Kyte–Doolittle hydropathy), NCPR, the
disorder-promoting fraction and the low-complexity fraction (12-residue
windows under 2.2 bits); the JSON holds the disordered fraction and the
per-sequence rows. Proteins are read as ``ss_propensity`` reads them.
Host only.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np

# Kyte–Doolittle hydropathy
KD = {
    "A": 1.8, "R": -4.5, "N": -3.5, "D": -3.5, "C": 2.5, "Q": -3.5, "E": -3.5,
    "G": -0.4, "H": -3.2, "I": 4.5, "L": 3.8, "K": -3.9, "M": 1.9, "F": 2.8,
    "P": -1.6, "S": -0.8, "T": -0.7, "W": -0.9, "Y": -1.3, "V": 4.2,
}
DISORDER_PROMOTING = set("EDKRQSPG")
POSITIVE = set("KR")
NEGATIVE = set("DE")


def mean_hydropathy_normalized(seq: str) -> float:
    """KD hydropathy rescaled to [0, 1] (Uversky convention)."""
    vals = [(KD.get(a, 0.0) + 4.5) / 9.0 for a in seq]
    return sum(vals) / max(len(vals), 1)


def low_complexity_fraction(seq: str, window: int = 12,
                            entropy_threshold: float = 2.2) -> float:
    if len(seq) < window:
        return 0.0
    low = 0
    for i in range(len(seq) - window + 1):
        chunk = seq[i : i + window]
        counts: dict[str, int] = {}
        for a in chunk:
            counts[a] = counts.get(a, 0) + 1
        entropy = -sum((c / window) * math.log2(c / window) for c in counts.values())
        low += entropy < entropy_threshold
    return low / (len(seq) - window + 1)


def analyze(seq: str) -> dict:
    n = max(len(seq), 1)
    pos = sum(a in POSITIVE for a in seq)
    neg = sum(a in NEGATIVE for a in seq)
    mean_net_charge = abs(pos - neg) / n
    h = mean_hydropathy_normalized(seq)
    # Uversky boundary: <R> = 2.785 <H> − 1.151
    boundary_charge = 2.785 * h - 1.151
    return {
        "length": len(seq),
        "mean_hydropathy": round(h, 4),
        "mean_net_charge": round(mean_net_charge, 4),
        "ncpr": round((pos - neg) / n, 4),
        "uversky_disordered": bool(mean_net_charge > boundary_charge),
        "disorder_promoting_frac": round(sum(a in DISORDER_PROMOTING for a in seq) / n, 4),
        "low_complexity_frac": round(low_complexity_fraction(seq), 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--dna", help="one DNA CDS per line")
    group.add_argument("--protein", help="one protein sequence per line")
    ap.add_argument("--out", default="outputs/disorder/disorder_heuristics.json")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.ss_propensity import read_proteins

    rows = [{"index": i, **analyze(seq)}
            for i, seq in enumerate(read_proteins(args.dna, args.protein))]
    report = {
        "sequences": len(rows),
        "disordered_fraction": (float(np.mean([r["uversky_disordered"] for r in rows]))
                                if rows else None),
        "mean_disorder_promoting_frac": (
            float(np.mean([r["disorder_promoting_frac"] for r in rows])) if rows else None),
        "per_sequence": rows,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps({k: v for k, v in report.items() if k != "per_sequence"}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
