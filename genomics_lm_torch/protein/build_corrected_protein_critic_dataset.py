"""Build a provenance-bound, protein-cluster-held-out critic dataset (twin of
``scripts/build_corrected_protein_critic_dataset.py``, the same flags).

    python -m genomics_lm_torch.protein.build_corrected_protein_critic_dataset \\
        --annotations genome_annotations.tsv [--stability_csv megascale.csv] \\
        --out_dir data/processed/corrected_critic [--min_jaccard 0.5] [--seed 42]

Merges genome UniProt annotations (pfam/ec) and MegaScale stability rows,
clusters the sequences by homology with the native minhash tool
(``genomics_lm_torch/native``, built with ``g++`` at first use; it stands in
for the reference's MMseqs2 easy-cluster step), assigns whole clusters to
train/val/test, and freezes a critic manifest binding the split files by
sha256 (``protein/corrected_dataset.write_critic_manifest``). Host only.
"""

from __future__ import annotations

import argparse
import csv
import json
import random
from pathlib import Path

from genomics_lm_torch.native import minhash_cluster
from genomics_lm_torch.protein.corrected_dataset import write_critic_manifest

VALID_AA = set("ACDEFGHIKLMNPQRSTVWY")


def normalize_protein(seq: str) -> str:
    seq = (seq or "").strip().upper().rstrip("*")
    if not seq or set(seq) - VALID_AA:
        raise ValueError("invalid protein sequence")
    return seq


def load_annotation_records(path: Path) -> list[dict]:
    records = []
    with path.open(newline="") as f:
        reader = csv.DictReader(f, delimiter="\t" if path.suffix == ".tsv" else ",")
        for row in reader:
            try:
                seq = normalize_protein(row.get("sequence") or row.get("Sequence", ""))
            except ValueError:
                continue
            pid = (row.get("ncbi_id") or row.get("id") or row.get("Entry") or "").strip()
            pfam = [v.strip() for v in str(row.get("pfam", "")).split(";") if v.strip()]
            ec = str(row.get("ec", "")).strip()
            ec_label = int(ec[0]) if ec and ec[0].isdigit() and 1 <= int(ec[0]) <= 7 else None
            pfam_label = pfam[0] if pfam else None
            if pfam_label is None and ec_label is None:
                continue
            records.append({
                "sequence": seq, "source": "genome_uniprot_annotation",
                "source_ids": [pid], "pfam_label": pfam_label,
                "ec_label": ec_label, "stability_score": None,
            })
    return records


def load_stability_records(path: Path) -> list[dict]:
    records = []
    with path.open(newline="") as f:
        for row in csv.DictReader(f):
            try:
                seq = normalize_protein(row.get("aa_seq", ""))
                score = float(row["deltaG"])
            except (ValueError, KeyError):
                continue
            records.append({
                "sequence": seq, "source": "megascale_delta_g",
                "source_ids": [str(row.get("name", ""))],
                "pfam_label": None, "ec_label": None, "stability_score": score,
            })
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--annotations", default=None, help="genome annotation CSV/TSV")
    ap.add_argument("--stability_csv", default=None, help="MegaScale CSV")
    ap.add_argument("--out_dir", default="data/processed/corrected_critic")
    ap.add_argument("--min_jaccard", type=float, default=0.5,
                    help="homology-cluster threshold (k-mer jaccard)")
    ap.add_argument("--val_fraction", type=float, default=0.1)
    ap.add_argument("--test_fraction", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    records: list[dict] = []
    if args.annotations:
        records += load_annotation_records(Path(args.annotations))
    if args.stability_csv:
        records += load_stability_records(Path(args.stability_csv))
    if not records:
        raise SystemExit("no records — pass --annotations and/or --stability_csv")

    # dedupe identical sequences, merging labels
    by_seq: dict[str, dict] = {}
    for r in records:
        prev = by_seq.get(r["sequence"])
        if prev is None:
            by_seq[r["sequence"]] = dict(r)
        else:
            prev["source_ids"] = sorted(set(prev["source_ids"]) | set(r["source_ids"]))
            for key in ("pfam_label", "ec_label", "stability_score"):
                if prev.get(key) is None:
                    prev[key] = r.get(key)
    merged = list(by_seq.values())

    # homology clustering: whole clusters go to one split
    reps = minhash_cluster([r["sequence"] for r in merged],
                           min_jaccard=args.min_jaccard)
    clusters: dict[int, list[int]] = {}
    for i, rep in enumerate(reps):
        clusters.setdefault(int(rep), []).append(i)

    rng = random.Random(args.seed)
    cluster_ids = sorted(clusters)
    rng.shuffle(cluster_ids)
    n = len(merged)
    budget = {"test": args.test_fraction * n, "val": args.val_fraction * n}
    assignment: dict[int, str] = {}
    for cid in cluster_ids:
        size = len(clusters[cid])
        for split in ("test", "val"):
            if budget[split] > 0:
                assignment[cid] = split
                budget[split] -= size
                break
        else:
            assignment[cid] = "train"
    for cid, members in clusters.items():
        for i in members:
            merged[i]["split"] = assignment[cid]
            merged[i]["cluster_id"] = cid

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    split_paths = {}
    for split in ("train", "val", "test"):
        path = out_dir / f"critic_{split}.jsonl"
        with path.open("w") as f:
            for r in merged:
                if r["split"] == split:
                    f.write(json.dumps(r) + "\n")
        split_paths[split] = path

    task_vocabularies = {
        "pfam": sorted({r["pfam_label"] for r in merged if r["pfam_label"]}),
        "ec": sorted({r["ec_label"] for r in merged if r["ec_label"] is not None}),
    }
    manifest = write_critic_manifest(
        split_paths, task_vocabularies, out_dir / "critic_manifest.json"
    )
    print(json.dumps({
        "records": len(merged),
        "clusters": len(clusters),
        "split_counts": {s: sum(r["split"] == s for r in merged)
                         for s in ("train", "val", "test")},
        "task_vocab_sizes": {k: len(v) for k, v in task_vocabularies.items()},
        "manifest": str(out_dir / "critic_manifest.json"),
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
