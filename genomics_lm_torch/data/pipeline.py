"""Leakage-resistant dataset preparation: records → frozen packed dataset
(the port's own copy of ``genomics_lm_tpu/data/pipeline.py``, numpy only).

1. CDS records with a stable genome identity,
2. a deterministic group split by genome or genus (a seeded shuffle of the
   sorted groups), with an explicit non-scientific sequence split when
   fewer than 3 groups exist,
3. cross-split exact-duplicate quarantine (the highest-priority split keeps
   the family),
4. the leakage audit (``data/leakage.py``; its report is always written),
5. ambiguity-aware tokenization into fragments,
6. transition-exact chunking and packing → ``{split}_bs{block}.npz`` packs,
   uint8 mmap ``.npy`` sidecars and ``itos.txt``,
7. provenance TSVs, the content-addressed ``manifest.json`` and
   ``pipeline_prepare.json``.

Every artifact is the JAX package's byte for byte from the same records,
so the manifest's ``dataset.id`` is JAX's (``tests/test_torch_data_pipeline.py``);
``prepare_from_genbank`` feeds it the CDS records of GenBank files
(``tests/test_torch_genbank.py``).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

from genomics_lm_torch.data import leakage as leakage_lib
from genomics_lm_torch.data.genbank import extract_cds_records
from genomics_lm_torch.data import manifest as manifest_lib
from genomics_lm_torch.data.packing import (
    chunk_record,
    pack_chunks,
    packed_arrays,
    packing_metadata_rows,
)
from genomics_lm_torch.tokenizers import codon as codon_tok

SPLITS = ("train", "val", "test")


def assign_group_splits(
    records: Sequence[Mapping[str, Any]],
    *,
    group_by: str = "genome",
    fractions: Mapping[str, float] = {"val": 0.1, "test": 0.1},
    seed: int = 0,
    allow_sequence_split: bool = False,
) -> tuple[list[dict], dict]:
    """Deterministic group-disjoint split; sequence fallback under 3 groups."""
    records = [dict(r) for r in records]
    if group_by not in {"genome", "genus", "sequence"}:
        raise ValueError("group_by must be genome, genus, or sequence")

    effective = group_by
    groups = sorted({str(r.get(group_by, r["source_id"])) for r in records}) if group_by != "sequence" else []
    if group_by != "sequence" and len(groups) < 3:
        if not allow_sequence_split:
            raise leakage_lib.LeakageAuditError(
                f"fewer than 3 {group_by} groups ({len(groups)}); scientific "
                "preparation requires group-disjoint splits. Pass "
                "allow_sequence_split=True for an explicit non-scientific fallback."
            )
        effective = "sequence"

    rng = np.random.default_rng(seed)
    if effective == "sequence":
        order = rng.permutation(len(records))
        n = len(records)
        n_val = int(round(n * float(fractions.get("val", 0.1))))
        n_test = int(round(n * float(fractions.get("test", 0.1))))
        for rank, idx in enumerate(order):
            if rank < n_test:
                records[idx]["split"] = "test"
            elif rank < n_test + n_val:
                records[idx]["split"] = "val"
            else:
                records[idx]["split"] = "train"
        groups_by_split = None
    else:
        shuffled = list(groups)
        rng.shuffle(shuffled)
        n = len(shuffled)
        n_val = max(1, int(round(n * float(fractions.get("val", 0.1)))))
        n_test = max(1, int(round(n * float(fractions.get("test", 0.1)))))
        split_of_group = {}
        for rank, group in enumerate(shuffled):
            if rank < n_test:
                split_of_group[group] = "test"
            elif rank < n_test + n_val:
                split_of_group[group] = "val"
            else:
                split_of_group[group] = "train"
        # ensure a non-empty train split
        if not any(s == "train" for s in split_of_group.values()):
            split_of_group[shuffled[-1]] = "train"
        for r in records:
            r["split"] = split_of_group[str(r.get(group_by, r["source_id"]))]
        groups_by_split = {
            split: sorted(g for g, s in split_of_group.items() if s == split)
            for split in SPLITS
        }

    policy = {
        "requested_group_by": group_by,
        "effective_group_by": effective,
        "allow_sequence_split": bool(allow_sequence_split),
        "requested_fractions": {k: float(v) for k, v in fractions.items()},
        "scientific_valid": effective != "sequence",
        "record_counts": {
            split: sum(1 for r in records if r["split"] == split) for split in SPLITS
        },
    }
    if groups_by_split is not None:
        policy["groups_by_split"] = groups_by_split
    return records, policy


def _write_tsv(path: Path, rows: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        path.write_text("")
        return
    with path.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()), delimiter="\t")
        writer.writeheader()
        writer.writerows(rows)


def prepare_dataset(
    records: Sequence[Mapping[str, Any]],
    out_dir: str | Path,
    *,
    block_size: int = 512,
    pack_mode: str = "multi",
    group_by: str = "genome",
    fractions: Mapping[str, float] = {"val": 0.1, "test": 0.1},
    split_seed: int = 0,
    packing_seed: int = 0,
    min_fragment_codons: int = 10,
    termination: str = "eos",
    skip_homology: bool = True,
    audit_engine: str = "external",
    allow_sequence_split: bool = False,
    allow_exact_duplicates: bool = False,
    write_mmap_sidecars: bool = True,
) -> dict:
    """Run the full preparation; returns the finalized manifest dict.

    ``records``: dicts with ``sequence``, ``source_id``, and (for group
    splits) ``genome``/``genus`` identity columns.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    array_mode = "fixed" if pack_mode in {"single", "multi", "binpack"} else "dynamic"

    # 1-2: split
    records, split_policy = assign_group_splits(
        records, group_by=group_by, fractions=fractions, seed=split_seed,
        allow_sequence_split=allow_sequence_split,
    )

    # 3: exact-duplicate quarantine
    records, quarantine = leakage_lib.quarantine_cross_split_exact_duplicates(records)
    split_policy["record_counts"] = {
        split: sum(1 for r in records if r["split"] == split) for split in SPLITS
    }

    # 4: leakage audit (always writes its report)
    audit_path = out_dir / "leakage_audit.json"
    audit = leakage_lib.audit_source_records(
        records, audit_path,
        skip_homology=skip_homology,
        allow_exact_duplicates=allow_exact_duplicates,
        engine=audit_engine,
    )
    scientific_valid = (
        split_policy["scientific_valid"]
        and audit["status"] == "passed"
        and not skip_homology
        and audit_engine == "external"
        and not allow_exact_duplicates
    )
    split_policy["scientific_valid"] = scientific_valid

    # 5: tokenize into fragments
    fragment_rows = []
    tokenized: dict[str, list[dict]] = {split: [] for split in SPLITS}
    fragment_line_idx = 0
    tokenize_stats = dict.fromkeys(codon_tok.TOKENIZE_STATS_KEYS, 0)
    for source_line_idx, record in enumerate(records):
        result = codon_tok.tokenize_cds_fragments(
            record["sequence"], source_id=str(record["source_id"]),
            min_fragment_codons=min_fragment_codons, termination=termination,
        )
        codon_tok.add_fragment_stats(tokenize_stats, result)
        for fragment in result.fragments:
            tokenized[str(record["split"])].append({
                "tokens": fragment.ids,
                "source_id": str(record["source_id"]),
                "source_line_idx": source_line_idx,
                "fragment_line_idx": fragment_line_idx,
                "fragment_index": fragment.fragment_index,
                "split": str(record["split"]),
                "fragment_codon_start": fragment.codon_start,
                "fragment_codon_end": fragment.codon_end,
            })
            fragment_rows.append({
                "fragment_line_idx": fragment_line_idx,
                "source_line_idx": source_line_idx,
                "source_id": str(record["source_id"]),
                "split": str(record["split"]),
                "fragment_index": fragment.fragment_index,
                "codon_start": fragment.codon_start,
                "codon_end": fragment.codon_end,
            })
            tokenize_stats["retained_fragments"] += 1
            fragment_line_idx += 1

    # 6: chunk, pack, arrays, sidecars
    itos_path = out_dir / "itos.txt"
    codon_tok.write_itos(itos_path)
    artifacts: dict[str, Path] = {"vocabulary": itos_path}
    for split in SPLITS:
        chunks = [
            c for rec in tokenized[split] for c in chunk_record(rec, block_size)
        ]
        windows = pack_chunks(chunks, block_size=block_size, mode=pack_mode, sep_id=codon_tok.SEP_ID)
        arrays = packed_arrays(windows, block_size=block_size, mode=array_mode)
        npz_path = out_dir / f"{split}_bs{block_size}.npz"
        np.savez(npz_path, **{
            k: v for k, v in arrays.items()
            if k in {"X", "Y", "lengths"}
        })
        artifacts[f"{split}_tokens"] = npz_path
        if write_mmap_sidecars and array_mode == "fixed":
            for key, suffix, role in (("X", "_X.npy", "x_npy"), ("Y", "_Y.npy", "y_npy")):
                sidecar = npz_path.with_name(npz_path.stem + suffix)
                np.save(sidecar, arrays[key].astype(np.uint8))
                artifacts[f"{split}_{role}"] = sidecar
        meta_rows = packing_metadata_rows(split, windows)
        meta_path = out_dir / f"{split}_packing_metadata.tsv"
        _write_tsv(meta_path, meta_rows)
        artifacts[f"{split}_packing_metadata"] = meta_path

    # 7: provenance artifacts + manifest
    _write_tsv(out_dir / "fragment_metadata.tsv", fragment_rows)
    artifacts["fragment_metadata"] = out_dir / "fragment_metadata.tsv"
    source_rows = [
        {"source_id": str(r["source_id"]), "split": r["split"],
         **{k: r.get(k, "") for k in ("genome", "genus", "organism")}}
        for r in records
    ]
    _write_tsv(out_dir / "source_metadata.tsv", source_rows)
    artifacts["source_metadata"] = out_dir / "source_metadata.tsv"
    dna_path = out_dir / "source_dna.txt"
    dna_path.write_text(
        "\n".join(leakage_lib.normalize_cds(r["sequence"]) for r in records) + "\n"
    )
    artifacts["source_dna"] = dna_path
    artifacts["leakage_audit"] = audit_path

    manifest = {
        "schema": {"name": manifest_lib.SCHEMA_NAME, "version": manifest_lib.SCHEMA_VERSION},
        "dataset": {
            "source_record_count": len(records),
            "scientific_valid": scientific_valid,
        },
        "split_policy": split_policy,
        "quarantine": {k: v for k, v in quarantine.items() if k != "families"},
        "leakage_audit": {
            "status": audit["status"],
            "homology_audit_skipped": audit["homology_audit_skipped"],
            "exact_duplicate_override": audit["exact_duplicate_override"],
            "engine": audit.get("engine", "external"),
        },
        "vocabulary": {
            "size": len(codon_tok.VOCAB),
            "sha256": manifest_lib.file_sha256(itos_path),
            "special_tokens": {tok: i for i, tok in enumerate(codon_tok.SPECIALS)},
        },
        "tokenization": {
            "ambiguous_codon_policy": "fragment",
            "termination": termination,
            "min_fragment_codons": min_fragment_codons,
            "stats": tokenize_stats,
        },
        "packing": {
            "mode": {"single": "fixed", "multi": "multi", "dynamic": "dynamic", "binpack": "binpack"}[pack_mode],
            "block_size": block_size,
            "transition_policy": "exactly_once",
        },
        "reproducibility": {"split_seed": split_seed, "packing_seed": packing_seed},
        "sources": {},
        "artifacts": {
            name: manifest_lib.artifact_entry(path, out_dir, role=name)
            for name, path in artifacts.items()
        },
    }
    manifest = manifest_lib.finalize_manifest(manifest)
    manifest_path = out_dir / "manifest.json"
    manifest_path.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    manifest_lib.validate_dataset_manifest(manifest, manifest_path, verify_artifacts=True)

    (out_dir / "pipeline_prepare.json").write_text(json.dumps({
        "schema_version": 1,
        "dataset_id": manifest["dataset"]["id"],
        "record_count": len(records),
        "tokenization": tokenize_stats,
        "split_policy": split_policy,
        "quarantine_removed": quarantine["removed_record_count"],
        "scientific_valid": scientific_valid,
    }, indent=2) + "\n")
    return manifest


def prepare_from_genbank(
    gbff_paths: Sequence[str | Path],
    out_dir: str | Path,
    *,
    genus_of: Mapping[str, str] | None = None,
    **kwargs,
) -> dict:
    """GBFF files → prepared dataset (genome identity = record accession).

    The genus expression keeps JAX's precedence: it parses as
    ``(genus_of.get(...) or organism.split()[0]) if organism else ""``, so
    ``genus_of`` is not read for a record without an organism.
    """
    records = []
    for path in gbff_paths:
        for row in extract_cds_records(path):
            organism = row.get("organism", "")
            genus = (genus_of or {}).get(row["record"]) or organism.split()[0] if organism else ""
            records.append({
                "sequence": row["sequence"],
                "source_id": row["source_id"],
                "genome": row["record"],
                "genus": genus,
                "organism": organism,
            })
    return prepare_dataset(records, out_dir, **kwargs)


__all__ = ["assign_group_splits", "prepare_dataset", "prepare_from_genbank"]
