"""Audit generated sequences against training data (twin of
``scripts/audit_generated_sequences.py``, the same flags).

    python -m genomics_lm_torch.data.audit_generated_sequences \
        --training_csv records.tsv --generated_csv candidates.csv \
        [--nucleotide_window 30] [--protein_window 10] [--out audit.json]

Exact-window coverage of each generated CDS by the training records,
nucleotide and protein (``data/leakage.py::audit_generated_sequences``).
Host-only: no model runs.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path


def read_records(path: str, id_col: str, seq_col: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for i, record in enumerate(csv.DictReader(f, delimiter="\t" if path.endswith(".tsv") else ",")):
            seq = record.get(seq_col) or record.get("sequence") or record.get("dna")
            if seq:
                rows.append({"source_id": record.get(id_col) or f"r{i}", "sequence": seq})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--training_csv", required=True)
    ap.add_argument("--generated_csv", required=True)
    ap.add_argument("--nucleotide_window", type=int, default=30)
    ap.add_argument("--protein_window", type=int, default=10)
    ap.add_argument("--out", default="outputs/audits/generated_audit.json")
    args = ap.parse_args(argv)

    from genomics_lm_torch.data.leakage import audit_generated_sequences

    training = read_records(args.training_csv, "id", "sequence")
    generated = read_records(args.generated_csv, "id", "dna")
    report = audit_generated_sequences(
        training, generated, Path(args.out),
        nucleotide_window=args.nucleotide_window,
        protein_window=args.protein_window,
    )
    print(json.dumps(report["summary"], indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
