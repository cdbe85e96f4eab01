"""Manifest-bound "corrected" critic dataset variant (the port's copy of
``genomics_lm_tpu/protein/corrected_dataset.py``).

Parity: reference ``src/protein_lm/corrected_dataset.py`` — a critic dataset
whose JSONL artifacts are bound fail-closed to a frozen manifest (sha256 +
byte size per artifact, task vocabularies pinned), so corrected critic runs
can prove which data they trained on.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

from genomics_lm_torch.protein.dataset import MultiTaskProteinDataset


class CorrectedCriticDatasetError(ValueError):
    """Raised when a corrected critic dataset fails its manifest binding."""


def _sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with path.open("rb") as handle:
        for chunk in iter(lambda: handle.read(1024 * 1024), b""):
            digest.update(chunk)
    return digest.hexdigest()


def load_critic_manifest(path: str | Path) -> dict:
    manifest_path = Path(path)
    try:
        manifest = json.loads(manifest_path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise CorrectedCriticDatasetError(
            f"cannot load critic manifest {manifest_path}: {exc}"
        ) from exc
    for key in ("schema", "splits", "task_vocabularies"):
        if key not in manifest:
            raise CorrectedCriticDatasetError(f"critic manifest missing {key!r}")
    return manifest


def bind_split(manifest: dict, manifest_path: Path, split: str) -> Path:
    """Resolve + verify one split's JSONL artifact against the manifest."""
    entry = manifest["splits"].get(split)
    if entry is None:
        raise CorrectedCriticDatasetError(f"critic manifest has no split {split!r}")
    path = Path(entry["path"])
    if not path.is_absolute():
        path = Path(manifest_path).parent / path
    if not path.exists():
        raise CorrectedCriticDatasetError(f"critic split {split} not found: {path}")
    if path.stat().st_size != int(entry["bytes"]):
        raise CorrectedCriticDatasetError(f"critic split {split} size mismatch: {path}")
    if _sha256(path) != entry["sha256"]:
        raise CorrectedCriticDatasetError(f"critic split {split} hash mismatch: {path}")
    return path


class CorrectedMultiTaskProteinDataset(MultiTaskProteinDataset):
    """MultiTaskProteinDataset constructed through manifest binding."""

    def __init__(
        self,
        manifest_path: str | Path,
        split: str,
        tokenizer,
        *,
        max_length: int = 512,
        multi_label_tasks=None,
    ):
        manifest = load_critic_manifest(manifest_path)
        jsonl_path = bind_split(manifest, Path(manifest_path), split)
        super().__init__(
            jsonl_path, tokenizer,
            max_length=max_length, multi_label_tasks=multi_label_tasks,
        )
        self.manifest = manifest
        self.split = split
        self.task_vocabularies = manifest["task_vocabularies"]

    @property
    def task_dims(self) -> dict[str, int]:
        return {task: len(vocab) for task, vocab in self.task_vocabularies.items()}


def write_critic_manifest(
    splits: dict[str, str | Path],
    task_vocabularies: dict[str, list],
    out_path: str | Path,
) -> dict:
    """Freeze a critic dataset: hash each split + pin task vocabularies."""
    out_path = Path(out_path)
    manifest = {
        "schema": {"name": "codonlm_critic_dataset", "version": 1},
        "splits": {},
        "task_vocabularies": task_vocabularies,
    }
    for split, path in splits.items():
        path = Path(path)
        try:
            stored = str(path.resolve().relative_to(out_path.parent.resolve()))
        except ValueError:
            stored = str(path.resolve())
        manifest["splits"][split] = {
            "path": stored,
            "bytes": path.stat().st_size,
            "sha256": _sha256(path),
        }
    out_path.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    return manifest


__all__ = [
    "CorrectedCriticDatasetError",
    "CorrectedMultiTaskProteinDataset",
    "bind_split",
    "load_critic_manifest",
    "write_critic_manifest",
]
