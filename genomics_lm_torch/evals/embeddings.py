"""Embedding extraction: pooled canonical causal states with provenance
(twin of ``genomics_lm_tpu/evals/embeddings.py``).

Hidden states come from ``models/codon_gpt.py::forward_hidden`` (the
final-norm canonical causal states; the flash forward on the card under
``attention_impl="flash"``, a MoE model routed dropless), pooled by mode:

- ``mean_nonpad``  — masked mean over non-PAD positions,
- ``mean_content`` — masked mean over codon tokens only,
- ``eos``          — the state at the last non-PAD position,

in the model's compute dtype, batched under ``torch.no_grad`` on the
model's device, and returned as float32 numpy; with sha256 provenance of
the checkpoint, vocabulary and dataset.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.models.codon_gpt import CodonGPT, forward_hidden
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.tokenizers.codon import CODON_BASE_ID
from genomics_lm_torch.utils.device import module_device

POOLING_MODES = ("mean_nonpad", "mean_content", "eos")


def _pooled_hidden(model: CodonGPT, cfg: CodonGPTConfig, idx: torch.Tensor,
                   mode: str) -> torch.Tensor:
    hidden = forward_hidden(model, cfg, idx)
    nonpad = idx != 0
    if mode == "mean_nonpad":
        mask = nonpad
    elif mode == "mean_content":
        mask = idx >= CODON_BASE_ID
    elif mode == "eos":
        positions = (nonpad.sum(dim=1) - 1).clamp_min(0)
        return hidden[torch.arange(hidden.shape[0], device=idx.device), positions]
    else:
        raise ValueError(f"unsupported pooling mode: {mode}")
    weights = mask.to(hidden.dtype)[:, :, None]
    return (hidden * weights).sum(dim=1) / weights.sum(dim=1).clamp_min(1.0)


@torch.no_grad()
def extract_embeddings(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    token_rows: np.ndarray,
    *,
    mode: str = "mean_nonpad",
    batch_size: int = 64,
) -> np.ndarray:
    """(N, block) int token rows → (N, D) float32 pooled embeddings."""
    if mode not in POOLING_MODES:
        raise ValueError(f"unsupported pooling mode: {mode}")
    device = module_device(model)
    out = []
    for start in range(0, len(token_rows), batch_size):
        batch = torch.from_numpy(
            np.asarray(token_rows[start:start + batch_size], np.int64)).to(device)
        out.append(_pooled_hidden(model, cfg, batch, mode).float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, cfg.n_embd), np.float32)


def ids_from_dna(dna: str, block_size: int) -> np.ndarray:
    """One CDS → fixed-width token row (BOS + codons, PAD-filled)."""
    from genomics_lm_torch.tokenizers.codon import to_ids

    ids = to_ids(dna, termination="eos")[:block_size]
    row = np.zeros(block_size, np.int32)
    row[: len(ids)] = ids
    return row


def file_sha256(path: str | Path) -> str:
    digest = hashlib.sha256()
    with Path(path).open("rb") as handle:
        for chunk in iter(lambda: handle.read(1024 * 1024), b""):
            digest.update(chunk)
    return digest.hexdigest()


def extraction_provenance(
    *,
    checkpoint_path: str | Path | None = None,
    itos_path: str | Path | None = None,
    dataset_manifest_id: str | None = None,
    pooling: str,
    n_sequences: int,
) -> dict:
    """Provenance block written next to embedding packs."""
    prov = {
        "schema_version": 1,
        "pooling": pooling,
        "n_sequences": int(n_sequences),
        "hidden_state_api": "forward_hidden(final-norm canonical causal states)",
    }
    if checkpoint_path is not None:
        prov["checkpoint"] = {
            "path": str(checkpoint_path),
            "sha256": file_sha256(checkpoint_path),
        }
    if itos_path is not None:
        prov["vocabulary"] = {
            "path": str(itos_path),
            "sha256": file_sha256(itos_path),
        }
    if dataset_manifest_id is not None:
        prov["dataset_id"] = dataset_manifest_id
    return prov


__all__ = [
    "POOLING_MODES",
    "extract_embeddings",
    "extraction_provenance",
    "file_sha256",
    "ids_from_dna",
]
