"""Fail-closed binding of an extraction to its frozen dataset, and of two
embedding packs to each other (the parts of
``genomics_lm_tpu/evals/provenance.py`` that ``extract_embeddings`` and
``train_classifier`` use).

- ``bind_dataset_manifest`` loads and validates a frozen manifest
  (``data/manifest.py``), checks ``scientific_valid`` when asked and pins
  chosen inputs to the manifest's own artifacts;
- ``bind_checkpoint_dataset`` holds the checkpoint's recorded dataset id
  and vocabulary hash to the manifest's (a checkpoint that records none is
  "legacy_checkpoint_unverified");
- ``bind_embedding_artifact`` reads a pack's ``<pack>.provenance.json``
  (what ``extract_embeddings`` writes) and, when verification is required,
  holds it to a causally verified extraction from a frozen manifest and a
  checkpoint bound to that manifest; ``bind_embedding_pair`` also holds a
  train and a test pack to one dataset id, one set of weights and one
  vocabulary.

Anything that cannot be bound raises ``EvaluationProvenanceError``. The
status strings are JAX's: they land in JSON that other tools read.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping

from genomics_lm_torch.data.manifest import (
    file_sha256,
    load_dataset_manifest,
    manifest_artifact_path,
)


class EvaluationProvenanceError(ValueError):
    """Evaluation inputs cannot be bound to one frozen dataset."""


def _refuse(message: str) -> None:
    raise EvaluationProvenanceError(message)


def _read_json(path: Path, what: str) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise EvaluationProvenanceError(f"cannot read {what} {path}: {exc}") from exc


def artifact_provenance(path: str | Path) -> dict:
    """Identity triple (path, bytes, sha256) of one on-disk artifact."""
    target = Path(path).expanduser().resolve()
    if not target.is_file():
        _refuse(f"evaluation artifact not found: {target}")
    return {
        "path": str(target),
        "bytes": target.stat().st_size,
        "sha256": file_sha256(target),
    }


def bind_dataset_manifest(
    manifest_path: str | Path,
    *,
    expected_artifacts: Mapping[str, str | Path] | None = None,
    require_scientific: bool = True,
) -> tuple[dict, dict]:
    """Validate the frozen manifest and pin chosen inputs to its artifacts."""
    location = Path(manifest_path).expanduser().resolve()
    manifest = load_dataset_manifest(location)
    dataset = manifest["dataset"]
    if require_scientific and not dataset.get("scientific_valid"):
        _refuse(f"dataset manifest is not marked scientific_valid: {location}")

    pinned: dict[str, dict] = {}
    for name, chosen in (expected_artifacts or {}).items():
        chosen_path = Path(chosen).expanduser().resolve()
        manifest_declares = manifest_artifact_path(manifest, location, name).resolve()
        if chosen_path != manifest_declares:
            _refuse(
                f"{name} input {chosen_path} does not match manifest artifact "
                f"{manifest_declares}"
            )
        pinned[name] = artifact_provenance(manifest_declares)

    vocab = manifest_artifact_path(manifest, location, "vocabulary").resolve()
    record = {
        "status": "frozen_manifest_verified",
        **artifact_provenance(location),
        "dataset_id": dataset["id"],
        "scientific_valid": bool(dataset["scientific_valid"]),
        "schema": manifest["schema"],
        "vocabulary": artifact_provenance(vocab),
        "bound_artifacts": pinned,
    }
    return manifest, record


def bind_checkpoint_dataset(
    checkpoint_cfg: Mapping,
    manifest_provenance: Mapping | None,
) -> dict:
    """Cross-check the checkpoint's recorded dataset against the manifest."""
    recorded = checkpoint_cfg.get("dataset_manifest")
    recorded_id = recorded.get("dataset_id") if isinstance(recorded, Mapping) else None
    if recorded_id is None:
        # pre-manifest checkpoint: nothing to verify, and nothing claimed
        return {"status": "legacy_checkpoint_unverified", "dataset_id": None}
    if manifest_provenance is None:
        _refuse("corrected checkpoint requires an explicit frozen dataset manifest")
    manifest_id = manifest_provenance.get("dataset_id")
    if recorded_id != manifest_id:
        _refuse(
            "checkpoint dataset identity mismatch: "
            f"checkpoint={recorded_id!r}, manifest={manifest_id!r}"
        )
    vocab_block = checkpoint_cfg.get("vocabulary")
    recorded_vocab_sha = (
        vocab_block.get("sha256") if isinstance(vocab_block, Mapping) else None
    )
    manifest_vocab_sha = manifest_provenance.get("vocabulary", {}).get("sha256")
    if recorded_vocab_sha is not None and recorded_vocab_sha != manifest_vocab_sha:
        _refuse(
            "checkpoint vocabulary mismatch: "
            f"checkpoint={recorded_vocab_sha!r}, manifest={manifest_vocab_sha!r}"
        )
    return {
        "status": "checkpoint_manifest_verified",
        "dataset_id": recorded_id,
        "vocabulary_sha256": recorded_vocab_sha,
    }


# --- embedding binding -------------------------------------------------------


def embedding_sidecar_path(embedding_path: str | Path) -> Path:
    """Embedding packs carry provenance in ``<pack>.provenance.json``."""
    pack = Path(embedding_path).expanduser().resolve()
    return pack.with_suffix(".provenance.json")


def bind_embedding_artifact(path: str | Path, *, require_verified: bool) -> dict:
    pack = Path(path).expanduser().resolve()
    sidecar = embedding_sidecar_path(pack)
    if not sidecar.is_file():
        if require_verified:
            _refuse(f"verified embedding provenance sidecar not found: {sidecar}")
        return {
            "status": "legacy_embedding_unverified",
            "embedding": artifact_provenance(pack),
        }
    extraction = _read_json(sidecar, "embedding provenance")
    if require_verified:
        if extraction.get("validation_status") != "causal_verified":
            _refuse(f"embedding is not causally verified: {pack}")
        manifest_block = extraction.get("dataset_manifest")
        if not isinstance(manifest_block, Mapping) or manifest_block.get(
            "status"
        ) != "frozen_manifest_verified":
            _refuse(f"embedding lacks frozen dataset provenance: {pack}")
        ckpt_block = extraction.get("checkpoint_dataset")
        if not isinstance(ckpt_block, Mapping) or ckpt_block.get(
            "status"
        ) != "checkpoint_manifest_verified":
            _refuse(f"embedding checkpoint is not bound to its dataset: {pack}")
    return {
        "status": "verified_embedding" if require_verified else "metadata_present",
        "embedding": artifact_provenance(pack),
        "metadata": artifact_provenance(sidecar),
        "extraction": extraction,
    }


def _pair_key(extraction: Mapping, field: str):
    if field == "dataset_id":
        block = extraction.get("dataset_manifest")
        return block.get("dataset_id") if isinstance(block, Mapping) else None
    if field == "model_weights_sha256":
        weights = extraction.get("model_weights")
        if isinstance(weights, Mapping) and weights.get("sha256"):
            return weights["sha256"]
        checkpoint = extraction.get("checkpoint")
        return checkpoint.get("sha256") if isinstance(checkpoint, Mapping) else None
    if field == "vocabulary_sha256":
        vocab = extraction.get("vocabulary")
        return vocab.get("sha256") if isinstance(vocab, Mapping) else None
    raise KeyError(field)


def bind_embedding_pair(
    train_path: str | Path,
    test_path: str | Path,
    *,
    require_verified: bool,
) -> dict:
    """Train/test packs must come from the same model, data, and vocabulary."""
    bound = {
        "train": bind_embedding_artifact(train_path, require_verified=require_verified),
        "test": bind_embedding_artifact(test_path, require_verified=require_verified),
    }
    if require_verified:
        disagreements = {}
        for field in ("dataset_id", "model_weights_sha256", "vocabulary_sha256"):
            values = (
                _pair_key(bound["train"]["extraction"], field),
                _pair_key(bound["test"]["extraction"], field),
            )
            if values[0] != values[1]:
                disagreements[field] = values
        if disagreements:
            _refuse(f"train/test embedding provenance mismatch: {disagreements}")
    return bound


__all__ = [
    "EvaluationProvenanceError",
    "artifact_provenance",
    "bind_checkpoint_dataset",
    "bind_dataset_manifest",
    "bind_embedding_artifact",
    "bind_embedding_pair",
    "embedding_sidecar_path",
]
