"""Fail-closed vocabulary contracts binding tokenizer, datasets, and model.

A copy of ``genomics_lm_tpu/data/vocabulary.py`` (numpy), verbatim apart
from its imports of the port's own ``data/manifest.py`` and
``training/checkpoints.py`` (the same ``.npz`` container, so
``checkpoint_array(path, "model/tok_emb")`` reads either package's
checkpoints). The port never imports the JAX package.

Behavioral spec (reference ``src/codonlm/training/vocabulary.py``): training
must resolve exactly one token table — the dataset-adjacent ``itos.txt``
shared by every shard, or an explicitly configured path that agrees with it
byte-for-byte — then prove that (a) the configured ``vocab_size`` equals the
table length, (b) every dataset token id lies in ``[0, size)``, and (c) any
resume checkpoint was trained against the same table (embedding/output rows,
stored hash, dataset id). The table is snapshotted into the run directory
and described by a ``vocabulary.json`` provenance record whose JSON schema
is a cross-framework data contract (kept key-compatible on purpose).

The checks are organized as small validators that append human-readable
issues; any accumulated issue raises ``VocabularyContractError``.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np

PROVENANCE_SCHEMA_VERSION = 1
ITOS_FILENAME = "itos.txt"


class VocabularyContractError(ValueError):
    """Tokenizer, dataset, config, and model token spaces disagree."""


def _sha256_file(path: Path) -> str:
    from genomics_lm_torch.data.manifest import file_sha256  # streamed, 1 MB chunks

    return file_sha256(path)


# --- token table ------------------------------------------------------------


def load_itos(path: Path) -> tuple[str, ...]:
    """Read one token per line; reject missing/empty/duplicate entries."""
    table_path = Path(path)
    if not table_path.exists():
        raise VocabularyContractError(f"Tokenizer vocabulary not found: {table_path}")
    lines = table_path.read_text().splitlines()
    if not lines:
        raise VocabularyContractError(f"Tokenizer vocabulary is empty: {table_path}")
    tokens = tuple(entry.strip() for entry in lines)
    blank = [tid for tid, tok in enumerate(tokens) if tok == ""]
    if blank:
        raise VocabularyContractError(
            f"Tokenizer vocabulary contains empty token IDs {blank}: {table_path}"
        )
    repeated = sorted(tok for tok, count in Counter(tokens).items() if count > 1)
    if repeated:
        raise VocabularyContractError(
            f"Tokenizer vocabulary contains duplicate tokens {repeated}: {table_path}"
        )
    return tokens


def resolve_itos_path(
    dataset_paths: Sequence[str | Path], configured_path: str | Path | None
) -> Path:
    """One shared dataset-adjacent table, else the configured fallback.

    Shards living in different directories must still agree on a single
    existing ``itos.txt``; a configured path that exists but differs
    byte-wise from the dataset-adjacent table is an error (two sources of
    truth), matching the reference's fail-closed resolution.
    """
    candidates = {
        Path(shard).expanduser().resolve().parent / ITOS_FILENAME
        for shard in dataset_paths
    }
    found = sorted(c for c in candidates if c.exists())
    if not found:
        if configured_path is None:
            raise VocabularyContractError(
                "No dataset-adjacent itos.txt or explicit itos_path was found"
            )
        return Path(configured_path).expanduser().resolve()
    if len(found) > 1 or len(candidates) != len(found):
        listing = ", ".join(str(c) for c in sorted(candidates))
        raise VocabularyContractError(
            f"Dataset shards do not resolve to one shared adjacent itos.txt: {listing}"
        )
    winner = found[0]
    if configured_path is not None:
        explicit = Path(configured_path).expanduser().resolve()
        if explicit.exists() and explicit.read_bytes() != winner.read_bytes():
            raise VocabularyContractError(
                f"Configured tokenizer {explicit} differs from dataset tokenizer {winner}"
            )
    return winner


# --- dataset token-id bounds -------------------------------------------------


@dataclass(frozen=True)
class DatasetTokenBounds:
    path: str
    minimum: int | None
    maximum: int | None
    arrays: tuple[str, ...]


def dataset_token_bounds(path_value: str | Path) -> DatasetTokenBounds:
    """Min/max token id over the shard's X (and Y) arrays.

    Prefers the mmap ``*_X.npy``/``*_Y.npy`` sidecars when present (no NPZ
    decompression); otherwise opens the ``.npz`` container.
    """
    shard = Path(path_value).expanduser().resolve()

    lo: int | None = None
    hi: int | None = None
    seen: list[str] = []

    def fold(name: str, array) -> None:
        nonlocal lo, hi
        seen.append(name)
        if array.size:
            lo = min(int(array.min()), lo) if lo is not None else int(array.min())
            hi = max(int(array.max()), hi) if hi is not None else int(array.max())

    sidecar_x = shard.with_name(f"{shard.stem}_X.npy")
    if sidecar_x.exists():
        fold("X", np.load(sidecar_x, mmap_mode="r"))
        sidecar_y = shard.with_name(f"{shard.stem}_Y.npy")
        if sidecar_y.exists():
            fold("Y", np.load(sidecar_y, mmap_mode="r"))
    else:
        if not shard.exists():
            raise VocabularyContractError(f"Dataset shard not found: {shard}")
        with np.load(shard, allow_pickle=False) as blob:
            if "X" not in blob:
                raise VocabularyContractError(f"Dataset shard has no X array: {shard}")
            for name in ("X", "Y"):
                if name in blob:
                    fold(name, blob[name])
    return DatasetTokenBounds(str(shard), lo, hi, tuple(seen))


# --- the contract ------------------------------------------------------------


@dataclass(frozen=True)
class VocabularyContract:
    source_path: Path
    tokens: tuple[str, ...]
    sha256: str
    configured_size: int | None
    dataset_bounds: tuple[DatasetTokenBounds, ...]

    @property
    def size(self) -> int:
        return len(self.tokens)

    def provenance(self, resolved_path: Path | None = None) -> dict:
        """The ``vocabulary.json`` record (cross-framework data contract)."""
        return {
            "schema_version": PROVENANCE_SCHEMA_VERSION,
            "source_path": str(self.source_path),
            "resolved_path": str(resolved_path or self.source_path),
            "sha256": self.sha256,
            "size": self.size,
            "configured_size": self.configured_size,
            "token_ids_contiguous": True,
            "dataset_bounds": [
                {
                    "path": b.path,
                    "minimum": b.minimum,
                    "maximum": b.maximum,
                    "arrays": list(b.arrays),
                }
                for b in self.dataset_bounds
            ],
            "legacy_adaptation": False,
        }


def resolve_vocabulary_contract(
    dataset_paths: Sequence[str | Path],
    *,
    configured_path: str | Path | None,
    configured_size: int | None,
) -> VocabularyContract:
    """Resolve + validate the full contract, or raise with every violation."""
    table_path = resolve_itos_path(dataset_paths, configured_path)
    tokens = load_itos(table_path)
    size = len(tokens)
    if configured_size is not None and int(configured_size) != size:
        raise VocabularyContractError(
            f"Configured vocab_size={configured_size} does not match tokenizer "
            f"vocabulary size={size} from {table_path}"
        )
    per_shard = tuple(dataset_token_bounds(p) for p in dataset_paths)
    for shard in per_shard:
        if shard.minimum is not None and shard.minimum < 0:
            raise VocabularyContractError(
                f"Dataset {shard.path} contains negative token ID {shard.minimum}"
            )
        if shard.maximum is not None and shard.maximum >= size:
            raise VocabularyContractError(
                f"Dataset {shard.path} contains token ID {shard.maximum}, but "
                f"tokenizer {table_path} defines valid IDs 0..{size - 1}"
            )
    return VocabularyContract(
        source_path=table_path,
        tokens=tokens,
        sha256=_sha256_file(table_path),
        configured_size=None if configured_size is None else int(configured_size),
        dataset_bounds=per_shard,
    )


def snapshot_vocabulary(contract: VocabularyContract, destination: Path) -> Path:
    """Copy the table into the run dir and verify the copy hash-faithfully."""
    target = Path(destination)
    target.parent.mkdir(parents=True, exist_ok=True)
    if contract.source_path != target.resolve():
        shutil.copy2(contract.source_path, target)
    if _sha256_file(target) != contract.sha256:
        raise VocabularyContractError(f"Vocabulary snapshot hash mismatch: {target}")
    return target.resolve()


def write_vocabulary_manifest(provenance: dict, path: Path) -> None:
    Path(path).write_text(json.dumps(provenance, indent=2, sort_keys=True) + "\n")


# --- resume validation -------------------------------------------------------


def checkpoint_embedding_rows(checkpoint_path: str | Path) -> tuple[int | None, int | None]:
    """(embedding rows, output rows) straight from the checkpoint container.

    This repo stores the untied head as ``model/head/w`` with shape
    (n_embd, vocab) — the *columns* are the output rows.
    """
    from genomics_lm_torch.training.checkpoints import checkpoint_array

    try:
        emb = int(checkpoint_array(checkpoint_path, "model/tok_emb").shape[0])
    except KeyError:
        emb = None
    try:
        out = int(checkpoint_array(checkpoint_path, "model/head/w").shape[1])
    except KeyError:
        out = None
    return emb, out


def validate_resume_checkpoint(
    checkpoint_path: str | Path,
    contract: VocabularyContract,
    *,
    dataset_id: str | None = None,
) -> None:
    """Fail closed unless the checkpoint provably matches the contract."""
    from genomics_lm_torch.training.checkpoints import load_checkpoint_meta

    meta = load_checkpoint_meta(checkpoint_path)
    stored_cfg = meta.get("cfg", {}) if isinstance(meta, dict) else {}

    issues: list[str] = []
    emb_rows, out_rows = checkpoint_embedding_rows(checkpoint_path)
    if emb_rows != contract.size:
        issues.append(f"embedding rows={emb_rows}")
    if out_rows is not None and out_rows != contract.size:
        issues.append(f"output rows={out_rows}")

    stored_size = stored_cfg.get("vocab_size")
    if stored_size is not None and int(stored_size) != contract.size:
        issues.append(f"checkpoint cfg vocab_size={stored_size}")

    stored_vocab = stored_cfg.get("vocabulary")
    stored_hash = stored_vocab.get("sha256") if isinstance(stored_vocab, dict) else None
    if stored_hash is not None and stored_hash != contract.sha256:
        issues.append(f"checkpoint vocabulary sha256={stored_hash}")

    if dataset_id is not None:
        stored_manifest = stored_cfg.get("dataset_manifest")
        stored_id = (
            stored_manifest.get("dataset_id")
            if isinstance(stored_manifest, dict)
            else None
        )
        if stored_id != dataset_id:
            issues.append(
                f"checkpoint dataset_id={stored_id!r}, current dataset_id={dataset_id!r}"
            )

    if issues:
        raise VocabularyContractError(
            f"Resume checkpoint {checkpoint_path} is incompatible with tokenizer "
            f"{contract.source_path} (size={contract.size}, sha256={contract.sha256}): "
            + ", ".join(issues)
            + ". Use transfer_from only for explicit legacy vocabulary adaptation."
        )


__all__ = [
    "DatasetTokenBounds",
    "ITOS_FILENAME",
    "PROVENANCE_SCHEMA_VERSION",
    "VocabularyContract",
    "VocabularyContractError",
    "checkpoint_embedding_rows",
    "dataset_token_bounds",
    "load_itos",
    "resolve_itos_path",
    "resolve_vocabulary_contract",
    "snapshot_vocabulary",
    "validate_resume_checkpoint",
    "write_vocabulary_manifest",
]
