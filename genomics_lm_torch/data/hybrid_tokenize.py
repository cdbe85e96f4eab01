"""Hybrid multi-scale tokenization CLI: GBFF → hybrid token id lines +
vocabulary (twin of ``scripts/hybrid_tokenize.py``, the same flags).

    python -m genomics_lm_torch.data.hybrid_tokenize --gbff a.gbff [b.gbff ...] \\
        --out_ids ids.txt [--out_itos itos_hybrid.txt] [--max_len 0]

One line of space-separated ids per GenBank record (``extract_hybrid_records``:
CDS as codons, the rest as bases, later overlapping CDS dropped), the
74-token ``itos`` beside it, and a JSON summary on stdout. Host only.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gbff", nargs="+", required=True)
    ap.add_argument("--out_ids", required=True)
    ap.add_argument("--out_itos", default=None)
    ap.add_argument("--max_len", type=int, default=0, help="0 = unlimited")
    args = ap.parse_args(argv)

    from genomics_lm_torch.data.genbank import extract_hybrid_records
    from genomics_lm_torch.tokenizers.hybrid import HybridTokenizer

    tokenizer = HybridTokenizer()
    out_ids = Path(args.out_ids)
    out_ids.parent.mkdir(parents=True, exist_ok=True)
    stats = {"records": 0, "tokens": 0, "dropped_overlapping_cds": 0}
    with out_ids.open("w") as fout:
        for path in args.gbff:
            for record in extract_hybrid_records(path):
                ids = tokenizer.encode(record["sequence"], record["cds_intervals"])
                if args.max_len:
                    ids = ids[: args.max_len]
                fout.write(" ".join(map(str, ids)) + "\n")
                stats["records"] += 1
                stats["tokens"] += len(ids)
                stats["dropped_overlapping_cds"] += record["dropped_overlapping"]
    itos_path = Path(args.out_itos or out_ids.with_name("itos_hybrid.txt"))
    itos_path.write_text("\n".join(tokenizer.vocab) + "\n")
    print(json.dumps({**stats, "vocab_size": tokenizer.vocab_size,
                      "itos": str(itos_path)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
