"""Next-token predictions for fixed genomic prefixes (twin of
``scripts/probe_next_token.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.probe_next_token <run_id> \\
        [--prefixes ATG,ATG-AAA,ATG-GAA,TAA] [--topk 5] [--npz split.npz] \\
        [--run_root runs] [--device cpu]

Each prefix goes through ``CachedDecoder`` (``make_decoder``: a prompt
forward, then one cached decode step, the decode kernel on the card) and
its top-k next tokens land in ``<run>/tables/next_token_probes.csv``. With
``--npz`` the held-out top-1/top-5 accuracy of ``evals/analysis.py``'s
``probe_next_token`` (8 batches of 32, the flash forward on the card) is
added and written to ``<run>/tables/next_token_probe.json``.
"""

from __future__ import annotations

import argparse
import csv
import json

PREFIXES = ["ATG", "ATG-AAA", "ATG-GAA", "TAA"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--prefixes", default=",".join(PREFIXES))
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--npz", default=None, help="held-out split for accuracy probe")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.playground import (
        dna_to_context_ids,
        make_decoder,
        query_next_codon,
    )
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)

    rows = []
    for prefix in args.prefixes.split(","):
        ids = dna_to_context_ids(prefix.replace("-", ""), stoi)
        top = query_next_codon(decoder, ids, itos, top_k=args.topk)
        for rank, entry in enumerate(top, start=1):
            rows.append({"prefix": prefix, "rank": rank, "token": entry["token"],
                         "prob": round(float(entry["prob"]), 6)})
    tables = run_dir / "tables"
    tables.mkdir(parents=True, exist_ok=True)
    with (tables / "next_token_probes.csv").open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["prefix", "rank", "token", "prob"])
        writer.writeheader()
        writer.writerows(rows)
    report = {"prefixes": rows}

    if args.npz:
        from genomics_lm_torch.data.datasets import PackedDataset
        from genomics_lm_torch.evals.analysis import probe_next_token

        report["accuracy"] = probe_next_token(decoder.model, decoder.cfg,
                                              PackedDataset(args.npz), tables)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
