"""Content-addressed dataset manifests (``codonlm_dataset_manifest`` v1).

A copy of ``genomics_lm_tpu/data/manifest.py`` (pure Python), verbatim
apart from its import of the port's own ``data/vocabulary.py``: the port
never imports the JAX package.

The on-disk JSON schema and the identity-hash recipe are a cross-framework
data contract shared with the reference (``src/codonlm/dataset_manifest.py``):
frozen corrected datasets must validate interchangeably, so the schema keys,
the volatile-field stripping, and the canonical-JSON hashing are kept
bit-for-bit compatible. The validation itself is organized as a chain of
focused check functions (schema → identity → split policy → scientific gate
→ section presence → artifact verification) rather than one monolith.

Checks enforced: split-count arithmetic, group disjointness,
``scientific_valid`` ⇒ clean-leakage-audit implication, the ``exactly_once``
packing transition policy, special-token mappings, per-artifact sha256 +
byte sizes, mmap-sidecar tracking, and token-bound checks.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Iterable

from genomics_lm_torch.data.vocabulary import dataset_token_bounds, load_itos

SCHEMA_NAME = "codonlm_dataset_manifest"
SCHEMA_VERSION = 1
SPLITS = ("train", "val", "test")

# every prepared dataset ships these named artifacts
REQUIRED_ARTIFACTS = (
    "train_tokens", "val_tokens", "test_tokens", "vocabulary",
    "source_metadata", "source_dna", "fragment_metadata", "leakage_audit",
    "train_packing_metadata", "val_packing_metadata", "test_packing_metadata",
)

# canonical special tokens every vocabulary must map
CORE_SPECIAL_TOKENS = ("<PAD>", "<BOS_CDS>", "<EOS_CDS>", "<SEP>")

# mmap sidecar suffixes and the artifact-role suffix that must track them
SIDECAR_ROLES = (
    ("_X.npy", "x_npy"),
    ("_Y.npy", "y_npy"),
    ("_lengths.npy", "lengths_npy"),
)


class DatasetManifestError(ValueError):
    """Raised when a dataset manifest is unsupported or inconsistent."""


def _fail(message: str) -> None:
    raise DatasetManifestError(message)


def _require(mapping: dict, key: str, context: str):
    if key not in mapping:
        _fail(f"missing {context}.{key}")
    return mapping[key]


# --- hashing / identity (data contract — byte-compatible) -------------------


def file_sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with Path(path).open("rb") as handle:
        while chunk := handle.read(1 << 20):
            digest.update(chunk)
    return digest.hexdigest()


_VOLATILE_TOP_KEYS = ("train", "val", "test", "datasets", "genome_sources")


def _identity_view(node: Any, *, drop: frozenset[str]) -> Any:
    """Deep-copy ``node`` without the keys in ``drop`` (one level's worth)."""
    if isinstance(node, dict):
        return {k: _identity_view(v, drop=frozenset()) for k, v in node.items() if k not in drop}
    if isinstance(node, list):
        return [_identity_view(v, drop=frozenset()) for v in node]
    return node


def _identity_payload(manifest: dict[str, Any]) -> dict[str, Any]:
    """Content identity ignores location-dependent fields: the dataset id
    itself, legacy top-level path blocks, itos/artifact/source paths."""
    view = _identity_view(manifest, drop=frozenset(_VOLATILE_TOP_KEYS))
    if isinstance(view.get("dataset"), dict):
        view["dataset"] = {k: v for k, v in view["dataset"].items() if k != "id"}
    if isinstance(view.get("vocabulary"), dict):
        view["vocabulary"] = {
            k: v for k, v in view["vocabulary"].items() if k != "itos_path"
        }
    for section in ("artifacts", "sources"):
        block = view.get(section)
        if isinstance(block, dict):
            view[section] = {
                name: {k: v for k, v in entry.items() if k != "path"}
                for name, entry in block.items()
            }
    return view


def dataset_identity(manifest: dict[str, Any]) -> str:
    canonical = json.dumps(
        _identity_payload(manifest),
        sort_keys=True, separators=(",", ":"), allow_nan=False,
    )
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()


def finalize_manifest(manifest: dict[str, Any]) -> dict[str, Any]:
    stamped = json.loads(json.dumps(manifest))  # deep copy via round-trip
    stamped.setdefault("dataset", {})["id"] = dataset_identity(stamped)
    return stamped


def artifact_entry(path: Path, manifest_dir: Path, role: str) -> dict[str, Any]:
    """Describe one file relative to the manifest (falls back to absolute)."""
    resolved = Path(path).resolve()
    base = Path(manifest_dir).resolve()
    stored = str(resolved.relative_to(base)) if resolved.is_relative_to(base) else str(resolved)
    return {
        "path": stored,
        "role": role,
        "bytes": resolved.stat().st_size,
        "sha256": file_sha256(resolved),
    }


def _resolve_artifact(manifest_path: Path, entry: dict) -> Path:
    raw = Path(_require(entry, "path", "artifact"))
    return raw if raw.is_absolute() else manifest_path.parent / raw


def manifest_artifact_path(manifest: dict, manifest_path: Path, name: str) -> Path:
    return _resolve_artifact(
        manifest_path, _require(manifest["artifacts"], name, "artifacts")
    )


# --- validators --------------------------------------------------------------


def _check_schema_and_identity(manifest: dict) -> None:
    schema = _require(manifest, "schema", "manifest")
    if (schema.get("name"), schema.get("version")) != (SCHEMA_NAME, SCHEMA_VERSION):
        _fail(
            f"unsupported dataset manifest schema: {schema!r}; "
            f"expected {SCHEMA_NAME} v{SCHEMA_VERSION}"
        )
    dataset = _require(manifest, "dataset", "manifest")
    declared = _require(dataset, "id", "dataset")
    actual = dataset_identity(manifest)
    if declared != actual:
        _fail(f"dataset identity mismatch: declared={declared}, computed={actual}")


def _check_split_policy(manifest: dict) -> None:
    policy = _require(manifest, "split_policy", "manifest")
    counts = _require(policy, "record_counts", "split_policy")
    if set(counts) != set(SPLITS) or min(int(counts[s]) for s in SPLITS) < 0:
        _fail("split record_counts must contain non-negative train/val/test")
    total = sum(int(counts[s]) for s in SPLITS)
    if total != int(manifest["dataset"]["source_record_count"]):
        _fail("split record counts do not sum to dataset source_record_count")
    fractions = _require(policy, "requested_fractions", "split_policy")
    for value in fractions.values():
        if not 0.0 <= float(value) < 1.0:
            _fail("requested split fractions must be in [0, 1)")
    assignment = policy.get("groups_by_split")
    if assignment:
        claimed: set = set()
        for split in SPLITS:
            members = set(assignment[split])
            if claimed & members:
                _fail("split groups overlap")
            claimed |= members


def _check_scientific_gate(manifest: dict) -> None:
    """``scientific_valid`` may only be claimed for a provably clean prep."""
    dataset_flag = bool(manifest["dataset"].get("scientific_valid"))
    policy = manifest["split_policy"]
    if dataset_flag != bool(policy.get("scientific_valid")):
        _fail("dataset and split_policy scientific_valid flags disagree")
    audit = _require(manifest, "leakage_audit", "manifest")
    if not dataset_flag:
        return
    unsafe = (
        policy.get("effective_group_by") == "sequence"
        or policy.get("allow_sequence_split")
        or audit.get("status") != "passed"
        or audit.get("homology_audit_skipped")
        or audit.get("exact_duplicate_override")
    )
    if unsafe:
        _fail("unsafe preparation cannot be marked scientific_valid")


def _check_sections(manifest: dict) -> None:
    vocabulary = _require(manifest, "vocabulary", "manifest")
    _require(manifest, "sources", "manifest")
    tokenization = _require(manifest, "tokenization", "manifest")
    packing = _require(manifest, "packing", "manifest")
    repro = _require(manifest, "reproducibility", "manifest")

    _require(tokenization, "ambiguous_codon_policy", "tokenization")
    if packing.get("mode") not in {"fixed", "dynamic", "multi", "binpack"}:
        _fail("packing.mode must be fixed, dynamic, multi, or binpack")
    if packing.get("transition_policy") != "exactly_once":
        _fail("packing transition_policy must be exactly_once")
    for seed in ("split_seed", "packing_seed"):
        _require(repro, seed, "reproducibility")
    specials = vocabulary.get("special_tokens", {})
    for token in CORE_SPECIAL_TOKENS:
        _require(specials, token, "vocabulary.special_tokens")
    artifacts = _require(manifest, "artifacts", "manifest")
    for name in REQUIRED_ARTIFACTS:
        _require(artifacts, name, "artifacts")


def _verify_file(path: Path, entry: dict, label: str) -> None:
    if not path.exists():
        _fail(f"{label} not found: {path}")
    if path.stat().st_size != int(entry["bytes"]):
        _fail(f"{label} size mismatch" + ("" if label.startswith("source") else f": {path}"))
    if file_sha256(path) != entry["sha256"]:
        _fail(f"{label} hash mismatch" + ("" if label.startswith("source") else f": {path}"))


def _verify_artifact_files(manifest: dict, manifest_path: Path) -> None:
    for name, source in manifest["sources"].items():
        _verify_file(Path(source["path"]), source, f"source {name}")
    artifacts = manifest["artifacts"]
    for name, entry in artifacts.items():
        _verify_file(_resolve_artifact(manifest_path, entry), entry, f"artifact {name}")

    # the vocabulary artifact must agree with the vocabulary section
    vocabulary = manifest["vocabulary"]
    vocab_path = _resolve_artifact(manifest_path, artifacts["vocabulary"])
    tokens = load_itos(vocab_path)
    if len(tokens) != int(vocabulary["size"]):
        _fail("vocabulary size does not match artifact")
    if file_sha256(vocab_path) != vocabulary["sha256"]:
        _fail("vocabulary hash does not match artifact")
    for token, raw_id in vocabulary["special_tokens"].items():
        tid = int(raw_id)
        if not (0 <= tid < len(tokens)) or tokens[tid] != token:
            _fail(f"special token mapping is invalid for {token}")

    # per-split token arrays: sidecars tracked, ids within the vocabulary
    for split in SPLITS:
        shard = _resolve_artifact(manifest_path, artifacts[f"{split}_tokens"])
        for suffix, role in SIDECAR_ROLES:
            sidecar = shard.with_name(shard.stem + suffix)
            if sidecar.exists() and f"{split}_{role}" not in artifacts:
                _fail(f"untracked memory-map sidecar for {split}: {sidecar}")
        span = dataset_token_bounds(shard)
        if span.minimum is not None and span.minimum < 0:
            _fail(f"{split} contains negative token IDs")
        if span.maximum is not None and span.maximum >= len(tokens):
            _fail(f"{split} token IDs exceed vocabulary")


def validate_dataset_manifest(
    manifest: dict[str, Any], manifest_path: Path, *, verify_artifacts: bool = True
) -> dict[str, Any]:
    _check_schema_and_identity(manifest)
    _check_split_policy(manifest)
    _check_scientific_gate(manifest)
    _check_sections(manifest)
    if verify_artifacts:
        _verify_artifact_files(manifest, manifest_path)
    return manifest


def load_dataset_manifest(path: str | Path, *, verify_artifacts: bool = True):
    manifest_path = Path(path).expanduser().resolve()
    try:
        manifest = json.loads(manifest_path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise DatasetManifestError(
            f"cannot load dataset manifest {manifest_path}: {exc}"
        ) from exc
    return validate_dataset_manifest(
        manifest, manifest_path, verify_artifacts=verify_artifacts
    )


def discover_manifest(dataset_paths: Iterable[str | Path]) -> Path | None:
    """The single ``manifest.json`` adjacent to every shard, or None.

    Only manifests declaring the ``codonlm_dataset_manifest`` schema are
    discovered: the hybrid pipeline's combined ``manifest.json``
    (hybrid_pipeline.py) is a path index, not a dataset contract, and must
    not bind as one. Fail-closed properties are preserved — an unparseable
    adjacent manifest.json still raises, and an explicitly configured
    ``dataset_manifest`` path bypasses discovery entirely.
    """
    adjacent = {
        Path(p).expanduser().resolve().parent / "manifest.json"
        for p in dataset_paths
    }
    present = {p for p in adjacent if p.exists()}
    if not present:
        return None
    if len(present) > 1 or len(adjacent) > 1:
        _fail("dataset shards do not share one adjacent manifest.json")
    found = present.pop()
    try:
        payload = json.loads(found.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise DatasetManifestError(
            f"cannot parse adjacent manifest {found}: {exc}"
        ) from exc
    schema = payload.get("schema") if isinstance(payload, dict) else None
    schema_name = schema.get("name") if isinstance(schema, dict) else schema
    if schema_name != SCHEMA_NAME:
        return None
    return found


__all__ = [
    "CORE_SPECIAL_TOKENS",
    "DatasetManifestError",
    "REQUIRED_ARTIFACTS",
    "SCHEMA_NAME",
    "SCHEMA_VERSION",
    "SPLITS",
    "artifact_entry",
    "dataset_identity",
    "discover_manifest",
    "file_sha256",
    "finalize_manifest",
    "load_dataset_manifest",
    "manifest_artifact_path",
    "validate_dataset_manifest",
]
