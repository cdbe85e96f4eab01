"""Dataset preparation CLI: GenBank files or a records TSV → frozen packed
dataset (twin of ``scripts/pipeline_prepare.py``, the same flags).

    python -m genomics_lm_torch.data.pipeline_prepare --gbff a.gbff b.gbff \
        --out_dir dataset [--block_size 512] [--pack_mode multi] [--group_by genome] \
        [--skip_homology] [--audit_engine external|native]
    python -m genomics_lm_torch.data.pipeline_prepare --records_tsv records.tsv \
        --out_dir dataset ...

``--gbff`` reads the CDS of each file (``data/genbank.py``; the genome is
the record's accession). The TSV has ``sequence``, ``source_id``,
``genome`` (and optionally ``genus``) columns. The homology audit runs
MMseqs2 and minimap2 (``--audit_engine external``), or the bundled minhash
tool (``--audit_engine native``: ``native/``, built with ``g++`` at first
use; the dataset is then marked non-scientific). Runs on the host only: no
device is involved.
"""

from __future__ import annotations

import argparse
import csv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gbff", nargs="*", default=[], help="GenBank flat files")
    ap.add_argument("--records_tsv", default=None,
                    help="TSV with sequence/source_id/genome[/genus] columns")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--block_size", type=int, default=512)
    ap.add_argument("--pack_mode", choices=["single", "multi", "dynamic"], default="multi")
    ap.add_argument("--group_by", choices=["genome", "genus", "sequence"], default="genome")
    ap.add_argument("--val_fraction", type=float, default=0.1)
    ap.add_argument("--test_fraction", type=float, default=0.1)
    ap.add_argument("--split_seed", type=int, default=0)
    ap.add_argument("--min_fragment_codons", type=int, default=10)
    ap.add_argument("--skip_homology", action="store_true")
    ap.add_argument("--audit_engine", choices=["external", "native"], default="external")
    ap.add_argument("--allow_sequence_split", action="store_true")
    ap.add_argument("--allow_exact_duplicates", action="store_true")
    args = ap.parse_args(argv)

    from genomics_lm_torch.data.pipeline import prepare_dataset, prepare_from_genbank

    kwargs = dict(
        block_size=args.block_size,
        pack_mode=args.pack_mode,
        group_by=args.group_by,
        fractions={"val": args.val_fraction, "test": args.test_fraction},
        split_seed=args.split_seed,
        min_fragment_codons=args.min_fragment_codons,
        skip_homology=args.skip_homology,
        audit_engine=args.audit_engine,
        allow_sequence_split=args.allow_sequence_split,
        allow_exact_duplicates=args.allow_exact_duplicates,
    )
    if args.gbff:
        manifest = prepare_from_genbank(args.gbff, args.out_dir, **kwargs)
    elif args.records_tsv:
        with open(args.records_tsv) as f:
            records = list(csv.DictReader(f, delimiter="\t"))
        manifest = prepare_dataset(records, args.out_dir, **kwargs)
    else:
        raise SystemExit("provide --gbff files or --records_tsv")
    print(f"[prepare] dataset_id={manifest['dataset']['id']}")
    print(f"[prepare] scientific_valid={manifest['dataset']['scientific_valid']}")
    print(f"[prepare] counts={manifest['split_policy']['record_counts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
