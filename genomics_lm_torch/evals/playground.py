"""Run loading for the query, sampling and serving CLIs (twin of
``genomics_lm_tpu/evals/playground.py``).

A run directory holds ``checkpoints/{best,last}.npz`` (or the checkpoints
at its root) in the ``.npz`` format both trainers write, and the run's
``itos.txt``. ``load_codon_model`` rebuilds the model from the saved run
config through ``utils/weights.py::params_from_jax`` on the card unless
the caller names another device; the legacy fallbacks stay: the vocabulary
size from the embedding rows when the config lacks it, the canonical
codon vocabulary when ``itos.txt`` is missing.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.generation.decode import CachedDecoder
from genomics_lm_torch.generation.genetic_code import translate_codons_to_aa  # noqa: F401
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.training.checkpoints import load_checkpoint
from genomics_lm_torch.utils.device import resolve_device
from genomics_lm_torch.utils.weights import params_from_jax

CHECKPOINT_PREFERENCE = ("best.npz", "last.npz")


def resolve_checkpoint(run_dir: str | Path, name: str | None = None) -> Path:
    """Find a checkpoint under ``<run>/checkpoints`` or the run root."""
    run_dir = Path(run_dir)
    candidates = []
    if name:
        candidates = [run_dir / "checkpoints" / name, run_dir / name, Path(name)]
    else:
        for preferred in CHECKPOINT_PREFERENCE:
            candidates += [run_dir / "checkpoints" / preferred, run_dir / preferred]
    for candidate in candidates:
        if candidate.is_file():
            return candidate
    raise FileNotFoundError(f"no checkpoint found under {run_dir}")


def load_codon_checkpoint(run_dir: str | Path, name: str | None = None) -> dict:
    return load_checkpoint(resolve_checkpoint(run_dir, name))


def build_codon_model_from_cfg(cfg_map: dict) -> CodonGPTConfig:
    """Full flag-set reconstruction from a saved run config."""
    return CodonGPTConfig.from_run_config(cfg_map)


def load_codon_model(run_dir: str | Path, name: str | None = None, *,
                     device: str | torch.device | None = None):
    """Load ``(model, cfg, itos, stoi)`` from a run directory; the model is
    on ``device`` (default: the CUDA card) in eval mode."""
    device = resolve_device(device)
    run_dir = Path(run_dir)
    payload = load_checkpoint(resolve_checkpoint(run_dir, name), keys=("cfg", "model"))
    cfg_map = dict(payload.get("cfg", {}))
    if "vocab_size" not in cfg_map:
        cfg_map["vocab_size"] = int(np.asarray(payload["model"]["tok_emb"]).shape[0])
    cfg = build_codon_model_from_cfg(cfg_map)
    model = params_from_jax(payload["model"], cfg, device)

    itos_path = run_dir / "itos.txt"
    if itos_path.exists():
        itos = [line.strip() for line in itos_path.read_text().splitlines() if line.strip()]
    else:
        from genomics_lm_torch.tokenizers.codon import VOCAB

        itos = list(VOCAB)
    stoi = {tok: i for i, tok in enumerate(itos)}
    return model, cfg, itos, stoi


def make_decoder(run_dir: str | Path, name: str | None = None, *,
                 device: str | torch.device | None = None):
    """``(CachedDecoder, itos, stoi)`` ready for querying and generation."""
    model, cfg, itos, stoi = load_codon_model(run_dir, name, device=device)
    return CachedDecoder(model, cfg.replace(dropout=0.0)), itos, stoi


def query_next_codon(decoder: CachedDecoder, ids: list[int], itos, top_k: int = 10):
    """Top-k next-token distribution after a context."""
    logits = decoder.next_logits(list(ids))
    logits = np.asarray(logits, np.float64)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    order = np.argsort(probs)[::-1][:top_k]
    return [
        {"token": itos[int(i)], "id": int(i), "prob": float(probs[int(i)])}
        for i in order
    ]


def dna_to_context_ids(dna: str, stoi: dict[str, int]) -> list[int]:
    """DNA prompt → [BOS, codons...] context."""
    s = dna.strip().upper().replace("U", "T")
    ids = [stoi.get("<BOS_CDS>", 1)]
    for i in range(0, (len(s) // 3) * 3, 3):
        tok = stoi.get(s[i : i + 3])
        if tok is not None:
            ids.append(tok)
    return ids


def score_sequence(decoder: CachedDecoder, ids: list[int]) -> dict:
    """Total/mean log-prob of a token sequence under the model."""
    total = 0.0
    count = 0
    for t in range(1, len(ids)):
        logits = np.asarray(decoder.next_logits(ids[:t]), np.float64)
        logz = np.log(np.exp(logits - logits.max()).sum()) + logits.max()
        total += float(logits[ids[t]] - logz)
        count += 1
    return {
        "total_logprob": total,
        "mean_logprob": total / max(count, 1),
        "perplexity": math.exp(-total / max(count, 1)),
        "tokens": count,
    }


__all__ = [
    "build_codon_model_from_cfg",
    "dna_to_context_ids",
    "load_codon_checkpoint",
    "load_codon_model",
    "make_decoder",
    "query_next_codon",
    "resolve_checkpoint",
    "score_sequence",
    "translate_codons_to_aa",
]
