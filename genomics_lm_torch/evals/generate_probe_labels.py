"""Biology-aware probe labels for codon tokens (twin of
``scripts/generate_probe_labels.py``, the same flags).

    python -m genomics_lm_torch.evals.generate_probe_labels <run_id> [--run_root runs]

One row a token of the run's ``itos.txt`` (amino acid, class, GC content,
start/stop, degeneracy, wobble base from ``generation/genetic_code.py``)
in ``<run>/probe_labels.csv``, which the linear-probe step reads. Host only.
"""

from __future__ import annotations

import argparse
import csv
import json

HYDROPHOBIC = set("AVLIMFWPC")
CHARGED = set("DEKRH")
POLAR = set("STYNQG")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--run_root", default="runs")
    args = ap.parse_args(argv)

    from genomics_lm_torch.generation.genetic_code import AA_TO_CODONS, CODON_TABLE
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    itos_path = run_dir / "itos.txt"
    if not itos_path.exists():
        raise SystemExit(f"{itos_path} not found")
    itos = itos_path.read_text().splitlines()

    degeneracy = {codon: len(AA_TO_CODONS[aa])
                  for aa, codons in AA_TO_CODONS.items() for codon in codons}
    stop_codons = {c for c, aa in CODON_TABLE.items() if aa in ("_", "*")}
    rows = []
    for idx, tok in enumerate(itos):
        is_codon = len(tok) == 3 and "<" not in tok
        aa = CODON_TABLE.get(tok, "") if is_codon else ""
        if tok in stop_codons:
            aa_class = "stop"
        elif aa in HYDROPHOBIC:
            aa_class = "hydrophobic"
        elif aa in CHARGED:
            aa_class = "charged"
        elif aa in POLAR:
            aa_class = "polar"
        else:
            aa_class = "special"
        rows.append({
            "token_id": idx,
            "token": tok,
            "is_codon": int(is_codon),
            "amino_acid": aa,
            "aa_class": aa_class,
            "gc_content": (sum(c in "GC" for c in tok) / 3 if is_codon else ""),
            "is_start": int(tok == "ATG"),
            "is_stop": int(tok in stop_codons),
            "degeneracy": degeneracy.get(tok, ""),
            "wobble_base": tok[2] if is_codon else "",
        })

    out = run_dir / "probe_labels.csv"
    with out.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(json.dumps({"tokens": len(rows), "out": str(out)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
