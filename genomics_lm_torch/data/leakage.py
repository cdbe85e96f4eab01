"""Cross-split leakage audits for dataset preparation (the port's own copy
of ``genomics_lm_tpu/data/leakage.py``, torch-free).

- sha256 exact-CDS duplicate detection and the keep-highest-priority-split
  quarantine policy,
- MMseqs2 ``easy-cluster`` protein clustering + cross-split cluster
  violations, minimap2 nucleotide and MMseqs2 protein nearest neighbors
  (external tools, run as subprocesses; missing tools fail closed with
  ``LeakageAuditError``, as in JAX),
- ``block``/``report`` policies and a JSON report written on every outcome;
- ``audit_generated_sequences``: the exact-window (matching-substring)
  coverage of generated sequences by the training records, nucleotide and
  protein, with its JSON report.

Translation uses the standard genetic code (stops inside become ``X``, a
trailing stop is trimmed). ``engine="native"`` clusters the translated
proteins with the bundled minhash tool (``genomics_lm_torch/native``)
instead of MMseqs2 and marks the report non-scientific; a library that
cannot be built fails the audit closed, with the report written.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
from collections import defaultdict
from pathlib import Path
from statistics import median
from typing import Any, Iterable, Mapping, Sequence

from genomics_lm_torch import native
from genomics_lm_torch.generation.genetic_code import CODON_TABLE

SPLIT_ORDER = {"train": 0, "val": 1, "test": 2}


class LeakageAuditError(RuntimeError):
    """Raised when a blocking leakage audit cannot pass."""


def normalize_cds(sequence: str) -> str:
    """Canonical DNA representation used for exact hashing."""
    return "".join(str(sequence).split()).upper().replace("U", "T")


def translate_cds(sequence: str, table: int = 11) -> str:
    """Translate a normalized CDS, keeping internal stops as ``X``."""
    normalized = normalize_cds(sequence)
    usable = normalized[: len(normalized) - (len(normalized) % 3)]
    if not usable:
        return ""
    aa = [CODON_TABLE.get(usable[i : i + 3], "X") for i in range(0, len(usable), 3)]
    protein = "".join("*" if c == "_" else c for c in aa)
    if protein.endswith("*"):
        protein = protein[:-1]
    return protein.replace("*", "X")


def _record_hash(record: Mapping[str, Any]) -> str:
    return hashlib.sha256(normalize_cds(record["sequence"]).encode("ascii")).hexdigest()


def exact_cross_split_duplicates(records: Sequence[Mapping[str, Any]]) -> list[dict]:
    """Full-CDS hashes whose source records occur in multiple splits."""
    by_hash: dict[str, list[Mapping[str, Any]]] = defaultdict(list)
    for record in records:
        by_hash[_record_hash(record)].append(record)
    violations = []
    for digest, members in sorted(by_hash.items()):
        splits = sorted({str(m["split"]) for m in members}, key=SPLIT_ORDER.get)
        if len(splits) < 2:
            continue
        violations.append({
            "sha256": digest,
            "splits": splits,
            "source_ids": sorted(str(m["source_id"]) for m in members),
        })
    return violations


def quarantine_cross_split_exact_duplicates(
    records: Sequence[Mapping[str, Any]],
    *,
    split_priority: Sequence[str] = ("test", "val", "train"),
) -> tuple[list[Mapping[str, Any]], dict[str, Any]]:
    """Keep cross-split duplicate families only in the highest-priority split."""
    priority = {split: index for index, split in enumerate(split_priority)}
    if set(priority) != set(SPLIT_ORDER):
        raise ValueError("split_priority must contain train, val, and test exactly once")

    by_hash: dict[str, list[Mapping[str, Any]]] = defaultdict(list)
    for record in records:
        by_hash[_record_hash(record)].append(record)

    removed_ids: set[int] = set()
    families = []
    removed_by_split = {split: 0 for split in SPLIT_ORDER}
    for digest, members in sorted(by_hash.items()):
        splits = {str(m["split"]) for m in members}
        if len(splits) < 2:
            continue
        kept_split = min(splits, key=priority.__getitem__)
        removed = [m for m in members if str(m["split"]) != kept_split]
        for member in removed:
            removed_ids.add(id(member))
            removed_by_split[str(member["split"])] += 1
        families.append({
            "sha256": digest,
            "kept_split": kept_split,
            "kept_source_ids": sorted(
                str(m["source_id"]) for m in members if str(m["split"]) == kept_split
            ),
            "removed_source_ids": sorted(str(m["source_id"]) for m in removed),
        })

    retained = [r for r in records if id(r) not in removed_ids]
    return retained, {
        "policy": "keep_highest_priority_split",
        "split_priority": list(split_priority),
        "duplicate_family_count": len(families),
        "removed_record_count": len(removed_ids),
        "removed_by_split": removed_by_split,
        "families": families,
    }


def cross_split_cluster_violations(
    clusters: Mapping[str, Sequence[str]],
    split_by_source: Mapping[str, str],
) -> list[dict[str, Any]]:
    """Clusters whose members span more than one split."""
    violations = []
    for representative, members in sorted(clusters.items()):
        source_ids = sorted(set(members))
        splits = sorted(
            {split_by_source[sid] for sid in source_ids}, key=SPLIT_ORDER.get
        )
        if len(splits) > 1:
            violations.append({
                "representative": representative,
                "splits": splits,
                "source_ids": source_ids,
            })
    return violations


def matching_substring_coverage(
    sequence: str, training_sequences: Sequence[str], window_size: int
) -> float:
    """Fraction of query positions covered by exact training windows."""
    if window_size < 1:
        raise ValueError("window_size must be at least 1")
    if len(sequence) < window_size:
        return 0.0
    training_windows = {
        t[start : start + window_size]
        for t in training_sequences
        for start in range(max(0, len(t) - window_size + 1))
    }
    if not training_windows:
        return 0.0
    covered = bytearray(len(sequence))
    for start in range(len(sequence) - window_size + 1):
        if sequence[start : start + window_size] in training_windows:
            covered[start : start + window_size] = b"\x01" * window_size
    return sum(covered) / len(sequence)


def identity_summary(rows: Sequence[Mapping[str, Any]]) -> dict[str, Any]:
    identities = sorted(float(r["identity"]) for r in rows)
    if not identities:
        return {"count": 0, "min": None, "median": None, "p90": None, "p95": None, "max": None}

    def percentile(fraction: float) -> float:
        index = fraction * (len(identities) - 1)
        lower = int(index)
        upper = min(lower + 1, len(identities) - 1)
        weight = index - lower
        return identities[lower] * (1.0 - weight) + identities[upper] * weight

    return {
        "count": len(identities),
        "min": identities[0],
        "median": median(identities),
        "p90": percentile(0.9),
        "p95": percentile(0.95),
        "max": identities[-1],
    }


# --- External C++ tools (MMseqs2, minimap2) ----------------------------------


def _write_fasta(path: Path, records: Iterable[tuple[str, str]]) -> None:
    with path.open("w") as handle:
        for source_id, sequence in records:
            handle.write(f">{source_id}\n{sequence}\n")


def _run(command: list[str], commands: list[list[str]]) -> subprocess.CompletedProcess:
    commands.append(command)
    try:
        return subprocess.run(command, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as exc:
        detail = (exc.stderr or exc.stdout or "").strip()
        suffix = f": {detail}" if detail else ""
        raise LeakageAuditError(
            f"external audit command failed with exit code {exc.returncode}: "
            f"{' '.join(command)}{suffix}"
        ) from exc


def _parse_clusters(path: Path) -> dict[str, list[str]]:
    clusters: dict[str, list[str]] = defaultdict(list)
    with path.open() as handle:
        for line in handle:
            representative, member = line.rstrip("\n").split("\t")[:2]
            clusters[representative].append(member)
    return dict(clusters)


def _parse_nearest(path: Path) -> list[dict[str, Any]]:
    rows = []
    if not path.exists():
        return rows
    with path.open() as handle:
        for line in handle:
            fields = line.rstrip("\n").split("\t")
            query, target, pident, alnlen, qlen, tlen = fields[:6]
            rows.append({
                "query_id": query,
                "target_id": target,
                "identity": float(pident) / 100.0,
                "alignment_length": int(alnlen),
                "query_length": int(qlen),
                "target_length": int(tlen),
                "query_coverage": int(alnlen) / max(1, int(qlen)),
                "bits": float(fields[6]) if len(fields) > 6 else None,
            })
    return rows


def _parse_minimap_paf(path: Path) -> list[dict[str, Any]]:
    """Best primary nucleotide alignment per query from a PAF file."""
    best: dict[str, dict[str, Any]] = {}
    if not path.exists():
        return []
    with path.open() as handle:
        for line in handle:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 12:
                continue
            query, qlen = fields[0], int(fields[1])
            target, tlen = fields[5], int(fields[6])
            matches, alnlen, mapq = int(fields[9]), int(fields[10]), int(fields[11])
            row = {
                "query_id": query,
                "target_id": target,
                "identity": matches / max(1, alnlen),
                "alignment_length": alnlen,
                "query_length": qlen,
                "target_length": tlen,
                "query_coverage": alnlen / max(1, qlen),
                "mapq": mapq,
                "matching_bases": matches,
            }
            score = (matches, alnlen, mapq, target)
            previous = best.get(query)
            if previous is None or score > previous["_score"]:
                row["_score"] = score
                best[query] = row
    rows = []
    for query in sorted(best):
        row = best[query]
        row.pop("_score", None)
        rows.append(row)
    return rows


def run_mmseqs_audit(
    records: Sequence[Mapping[str, Any]],
    work_dir: Path,
    *,
    min_protein_identity: float,
    min_coverage: float,
    threads: int = 1,
    executable: str = "mmseqs",
    nucleotide_executable: str = "minimap2",
    nucleotide_preset: str = "asm20",
    nearest_query_batch_size: int = 4096,
    split_memory_limit: str = "0",
) -> dict[str, Any]:
    """Cluster translated CDS records and find held-out nearest neighbors.

    Fail-closed: both external C++ tools must be resolvable, matching the
    reference's scientific-preparation requirement.
    """
    if nearest_query_batch_size < 1:
        raise ValueError("nearest_query_batch_size must be at least 1")
    resolved = shutil.which(executable)
    if resolved is None:
        raise LeakageAuditError(
            f"MMseqs2 executable {executable!r} was not found; scientific "
            "preparation requires the protein-homology audit"
        )
    resolved_nucleotide = shutil.which(nucleotide_executable)
    if resolved_nucleotide is None:
        raise LeakageAuditError(
            f"nucleotide aligner {nucleotide_executable!r} was not found; "
            "scientific preparation requires the nucleotide nearest-neighbor audit"
        )
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    commands: list[list[str]] = []
    version = (_run([resolved, "version"], commands).stdout or "").strip()
    nt_version = (_run([resolved_nucleotide, "--version"], commands).stdout or "").strip()

    proteins = [
        (str(r["source_id"]), translate_cds(r["sequence"])) for r in records
    ]
    proteins = [(sid, seq) for sid, seq in proteins if seq]
    protein_fasta = work_dir / "all_proteins.fasta"
    _write_fasta(protein_fasta, proteins)
    cluster_prefix = work_dir / "protein_clusters"
    _run(
        [
            resolved, "easy-cluster", str(protein_fasta), str(cluster_prefix),
            str(work_dir / "cluster_tmp"),
            "--min-seq-id", str(min_protein_identity),
            "-c", str(min_coverage), "--cov-mode", "0", "--cluster-mode", "0",
            "--threads", str(threads),
        ],
        commands,
    )
    clusters = _parse_clusters(Path(f"{cluster_prefix}_cluster.tsv"))

    train = [r for r in records if r["split"] == "train"]
    held_out = [r for r in records if r["split"] in {"val", "test"}]
    nearest: dict[str, Any] = {}

    # nucleotide nearest neighbors (minimap2 PAF)
    train_nt = work_dir / "train_nucleotide.fasta"
    _write_fasta(train_nt, ((str(r["source_id"]), normalize_cds(r["sequence"])) for r in train))
    query_nt = work_dir / "held_out_nucleotide.fasta"
    _write_fasta(query_nt, ((str(r["source_id"]), normalize_cds(r["sequence"])) for r in held_out))
    result = _run(
        [resolved_nucleotide, "-x", nucleotide_preset, "--secondary=no",
         "-t", str(threads), str(train_nt), str(query_nt)],
        commands,
    )
    paf = work_dir / "nearest_nucleotide.paf"
    paf.write_text(result.stdout)
    nt_rows = _parse_minimap_paf(paf)
    nearest["nucleotide"] = {
        "artifact": str(paf),
        "tool": {"name": "Minimap2", "executable": resolved_nucleotide,
                 "version": nt_version, "preset": nucleotide_preset},
        "query_batch_count": 1,
        "query_count": len(held_out),
        "hit_count": len(nt_rows),
        "hit_fraction": len(nt_rows) / len(held_out) if held_out else 0.0,
        "summary": identity_summary(nt_rows),
    }

    # protein nearest neighbors (mmseqs easy-search, batched)
    train_fasta = work_dir / "train_protein.fasta"
    _write_fasta(train_fasta, ((str(r["source_id"]), translate_cds(r["sequence"])) for r in train))
    output = work_dir / "nearest_protein.tsv"
    output.write_text("")
    converted = [(str(r["source_id"]), translate_cds(r["sequence"])) for r in held_out]
    rows: list[dict] = []
    for batch_index, start in enumerate(range(0, len(converted), nearest_query_batch_size)):
        query_fasta = work_dir / f"held_out_protein_{batch_index:04d}.fasta"
        part = work_dir / f"nearest_protein_{batch_index:04d}.tsv"
        _write_fasta(query_fasta, converted[start : start + nearest_query_batch_size])
        _run(
            [
                resolved, "easy-search", str(query_fasta), str(train_fasta),
                str(part), str(work_dir / f"search_{batch_index:04d}_tmp"),
                "--format-output", "query,target,pident,alnlen,qlen,tlen",
                "--max-seqs", "1", "--search-type", "1",
                "--split-memory-limit", split_memory_limit,
                "--threads", str(threads),
            ],
            commands,
        )
        with output.open("a") as handle:
            handle.write(part.read_text() if part.exists() else "")
        rows.extend(_parse_nearest(part))
    nearest["protein"] = {
        "artifact": str(output),
        "query_batch_count": (len(converted) + nearest_query_batch_size - 1)
        // nearest_query_batch_size,
        "query_count": len(converted),
        "hit_count": len(rows),
        "hit_fraction": len(rows) / len(converted) if converted else 0.0,
        "summary": identity_summary(rows),
    }

    return {
        "tool": {"name": "MMseqs2", "executable": resolved, "version": version},
        "nucleotide_tool": {"name": "Minimap2", "executable": resolved_nucleotide,
                            "version": nt_version, "preset": nucleotide_preset},
        "parameters": {
            "min_protein_identity": min_protein_identity,
            "min_coverage": min_coverage,
            "cov_mode": 0,
            "cluster_mode": 0,
            "threads": threads,
            "nearest_query_batch_size": nearest_query_batch_size,
            "split_memory_limit": split_memory_limit,
        },
        "commands": commands,
        "cluster_artifact": str(Path(f"{cluster_prefix}_cluster.tsv")),
        "_clusters": clusters,
        "nearest_neighbors": nearest,
    }


def audit_source_records(
    records: Sequence[Mapping[str, Any]],
    output_path: Path,
    *,
    min_protein_identity: float = 0.3,
    min_coverage: float = 0.8,
    threads: int = 1,
    executable: str = "mmseqs",
    skip_homology: bool = False,
    allow_exact_duplicates: bool = False,
    protein_homology_policy: str = "block",
    nucleotide_executable: str = "minimap2",
    nucleotide_preset: str = "asm20",
    nearest_query_batch_size: int = 4096,
    split_memory_limit: str = "0",
    engine: str = "external",
) -> dict[str, Any]:
    """Run blocking exact + homology audits and always write the JSON report.

    ``engine="native"`` clusters with the bundled C++ minhash tool instead of
    MMseqs2 (marks the report non-scientific: ``engine: native``).
    """
    if protein_homology_policy not in {"block", "report"}:
        raise ValueError("protein_homology_policy must be 'block' or 'report'")
    output_path = Path(output_path)
    exact = exact_cross_split_duplicates(records)
    report: dict[str, Any] = {
        "schema_version": 1,
        "status": "pending",
        "record_count": len(records),
        "thresholds": {
            "max_exact_cross_split_duplicates": 0,
            "max_cross_split_protein_clusters": (
                0 if protein_homology_policy == "block" else None
            ),
            "min_protein_identity": min_protein_identity,
            "min_coverage": min_coverage,
        },
        "exact_duplicates": {"count": len(exact), "violations": exact},
        "homology_audit_skipped": skip_homology,
        "exact_duplicate_override": allow_exact_duplicates,
        "protein_homology_policy": protein_homology_policy,
        "engine": engine,
    }
    blocking_reasons = []
    if exact and not allow_exact_duplicates:
        blocking_reasons.append("cross_split_exact_duplicates")

    try:
        if not skip_homology:
            split_by_source = {str(r["source_id"]): str(r["split"]) for r in records}
            if engine == "native":
                proteins = {
                    str(r["source_id"]): translate_cds(r["sequence"]) for r in records
                }
                try:
                    clusters = native.native_protein_clusters(
                        proteins, min_identity=min_protein_identity
                    )
                except RuntimeError as exc:  # the library did not build
                    raise LeakageAuditError(f"native homology tool: {exc}") from exc
                homology: dict[str, Any] = {
                    "tool": {"name": "genomics_native_minhash", "engine": "native"},
                    "parameters": {"min_protein_identity": min_protein_identity},
                }
            else:
                homology = run_mmseqs_audit(
                    records,
                    output_path.parent / "leakage_audit_work",
                    min_protein_identity=min_protein_identity,
                    min_coverage=min_coverage,
                    threads=threads,
                    executable=executable,
                    nucleotide_executable=nucleotide_executable,
                    nucleotide_preset=nucleotide_preset,
                    nearest_query_batch_size=nearest_query_batch_size,
                    split_memory_limit=split_memory_limit,
                )
                clusters = homology.pop("_clusters")
            protein_violations = cross_split_cluster_violations(clusters, split_by_source)
            homology["cluster_count"] = len(clusters)
            homology["cross_split_cluster_count"] = len(protein_violations)
            homology["cross_split_violations"] = protein_violations
            report["protein_homology"] = homology
            if protein_violations and protein_homology_policy == "block":
                blocking_reasons.append("cross_split_protein_clusters")
        else:
            report["protein_homology"] = None
    except (LeakageAuditError, subprocess.CalledProcessError, OSError, ValueError) as exc:
        report["status"] = "error"
        report["error"] = str(exc)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        output_path.write_text(json.dumps(report, indent=2) + "\n")
        raise LeakageAuditError(str(exc)) from exc

    report["blocking_reasons"] = blocking_reasons
    report["status"] = "failed" if blocking_reasons else "passed"
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(report, indent=2) + "\n")
    if blocking_reasons:
        raise LeakageAuditError("Leakage audit failed: " + ", ".join(blocking_reasons))
    return report


def audit_generated_sequences(
    training: Sequence[Mapping[str, Any]],
    generated: Sequence[Mapping[str, Any]],
    output_path: Path,
    *,
    nucleotide_window: int = 30,
    protein_window: int = 10,
) -> dict[str, Any]:
    """Matching-substring coverage of generated sequences vs training.

    The reference additionally reports aligner-based nearest neighbors when
    MMseqs2/minimap2 are present; the exact-window coverage metrics here are
    tool-free and always computed (``leakage_audit.py:603-…``).
    """
    output_path = Path(output_path)
    train_nt = [normalize_cds(r["sequence"]) for r in training]
    train_aa = [translate_cds(r["sequence"]) for r in training]
    rows = []
    for record in generated:
        nt = normalize_cds(record["sequence"])
        aa = translate_cds(record["sequence"])
        rows.append({
            "source_id": str(record["source_id"]),
            "nucleotide_coverage": matching_substring_coverage(
                nt, train_nt, nucleotide_window
            ),
            "protein_coverage": matching_substring_coverage(
                aa, train_aa, protein_window
            ),
        })
    report = {
        "schema_version": 1,
        "generated_count": len(generated),
        "training_count": len(training),
        "windows": {"nucleotide": nucleotide_window, "protein": protein_window},
        "coverage": rows,
        "summary": {
            "nucleotide": identity_summary(
                [{"identity": r["nucleotide_coverage"]} for r in rows]
            ),
            "protein": identity_summary(
                [{"identity": r["protein_coverage"]} for r in rows]
            ),
        },
    }
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(report, indent=2) + "\n")
    return report


__all__ = [
    "LeakageAuditError",
    "SPLIT_ORDER",
    "audit_generated_sequences",
    "audit_source_records",
    "cross_split_cluster_violations",
    "exact_cross_split_duplicates",
    "identity_summary",
    "matching_substring_coverage",
    "normalize_cds",
    "quarantine_cross_split_exact_duplicates",
    "run_mmseqs_audit",
    "translate_cds",
]
