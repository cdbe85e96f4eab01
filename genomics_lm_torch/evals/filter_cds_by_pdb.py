"""Select a CDS subset for structure-focused fine-tuning (twin of
``scripts/filter_cds_by_pdb.py``, the same flags).

    python -m genomics_lm_torch.evals.filter_cds_by_pdb --cds cds.txt \\
        (--uniprot_tsv uniprot.tsv | --line_indices keep.txt) --out kept.txt \\
        [--report report.json]

Keeps the CDS lines whose translated protein (``data/leakage.py``, the stop
removed) is a UniProt sequence with 3D-structure evidence (a PDB column or
the ``3D-structure`` keyword), or the lines named by index. Host only.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cds", required=True, help="one DNA sequence per line")
    ap.add_argument("--uniprot_tsv", default=None, help="TSV with Sequence + Keywords/PDB columns")
    ap.add_argument("--line_indices", default=None,
                    help="file of explicit 0-based line indices (one per line)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)

    from genomics_lm_torch.data.leakage import translate_cds

    sequences = Path(args.cds).read_text().splitlines()
    keep: list[int] = []
    if args.line_indices:
        mode = "explicit_line_indices"
        keep = [int(line) for line in Path(args.line_indices).read_text().split()
                if line.strip()]
        bad = [i for i in keep if i < 0 or i >= len(sequences)]
        if bad:
            raise SystemExit(f"line indices out of range: {bad[:5]}")
    elif args.uniprot_tsv:
        mode = "translated_protein_match"
        structured: set[str] = set()
        with open(args.uniprot_tsv) as f:
            for row in csv.DictReader(f, delimiter="\t"):
                seq, keywords, pdb = None, "", ""
                for key, value in row.items():
                    lk = key.lower()
                    if lk == "sequence":
                        seq = (value or "").strip().upper()
                    elif lk == "keywords":
                        keywords = value or ""
                    elif "pdb" in lk:
                        pdb = value or ""
                if seq and (pdb.strip() or "3d-structure" in keywords.lower()):
                    structured.add(seq)
        for i, dna in enumerate(sequences):
            try:
                protein = translate_cds(dna).rstrip("*")
            except Exception:  # the script skips any line it cannot translate
                continue
            if protein in structured:
                keep.append(i)
    else:
        raise SystemExit("pass --uniprot_tsv or --line_indices")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(sequences[i] for i in keep) + ("\n" if keep else ""))
    report = {"mode": mode, "input_sequences": len(sequences), "kept": len(keep),
              "out": str(out)}
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
