"""Fail-closed binding of an extraction to its frozen dataset (the part of
``genomics_lm_tpu/evals/provenance.py`` that ``extract_embeddings`` uses).

- ``bind_dataset_manifest`` loads and validates a frozen manifest
  (``data/manifest.py``), checks ``scientific_valid`` when asked and pins
  chosen inputs to the manifest's own artifacts;
- ``bind_checkpoint_dataset`` holds the checkpoint's recorded dataset id
  and vocabulary hash to the manifest's (a checkpoint that records none is
  "legacy_checkpoint_unverified").

Anything that cannot be bound raises ``EvaluationProvenanceError``. The
status strings are JAX's: they land in JSON that other tools read.
"""

from __future__ import annotations

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


__all__ = [
    "EvaluationProvenanceError",
    "artifact_provenance",
    "bind_checkpoint_dataset",
    "bind_dataset_manifest",
]
