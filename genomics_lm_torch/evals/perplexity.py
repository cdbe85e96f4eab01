"""Model perplexity over packed splits (twin of
``genomics_lm_tpu/evals/perplexity.py``).

Token-weighted corpus NLL and perplexity over the non-PAD targets of a
packed ``.npz`` split, per-row NLL sums in dataset row order (the unit of
the paired bootstrap), and the context-window ablation. Every batch runs
one ``forward`` under ``torch.no_grad`` on the model's device (the flash
forward on the card under ``attention_impl="flash"``, with
``attention_window`` passed through), and the log-sum-exp runs in
float32, as in JAX. ``evals/evaluate_test.py`` puts these beside the Markov
baselines and the paired bootstrap.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.data.datasets import EpochPlan, PackedDataset
from genomics_lm_torch.models.codon_gpt import CodonGPT, forward
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.utils.device import module_device


@torch.no_grad()
def _per_row_nll_sums(model: CodonGPT, cfg: CodonGPTConfig, x: np.ndarray, y: np.ndarray,
                      attention_window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (sum of per-token NLL over non-PAD targets, token count)."""
    device = module_device(model)
    x = torch.from_numpy(np.asarray(x)).to(device).long()
    y = torch.from_numpy(np.asarray(y)).to(device).long()
    logits, _ = forward(model, cfg, x, attention_window=attention_window)
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y[..., None])[..., 0]
    valid = y != 0
    return torch.where(valid, nll, 0.0).sum(dim=1), valid.sum(dim=1)


def _as_dataset(dataset) -> PackedDataset:
    return dataset if isinstance(dataset, PackedDataset) else PackedDataset(dataset)


def evaluate_perplexity(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    dataset: PackedDataset | str | Path,
    *,
    batch_size: int = 64,
    attention_window: int | None = None,
) -> dict:
    """Exact corpus NLL/PPL on a packed split."""
    dataset = _as_dataset(dataset)
    plan = EpochPlan(dataset, batch_size=batch_size, seed=0, epoch=0, shuffle=False)
    nll_sum = 0.0
    tokens = 0
    for x, y in plan.microbatches():
        if x.shape[0] == 0:
            continue
        s, n = _per_row_nll_sums(model, cfg, x, y, attention_window)
        nll_sum += float(s.sum())
        tokens += int(n.sum())
    nll = nll_sum / max(tokens, 1)
    return {
        "nll": nll,
        "perplexity": math.exp(min(nll, 50.0)),
        "bits_per_codon": nll / math.log(2),
        "tokens": tokens,
        "attention_window": attention_window,
    }


def per_row_model_nll(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    dataset: PackedDataset | str | Path,
    *,
    batch_size: int = 64,
    attention_window: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-packed-row (NLL sum, token count) in dataset row order: the
    resampling unit of the paired bootstrap."""
    dataset = _as_dataset(dataset)
    pad_to = None if not dataset.is_dynamic else int(dataset.seq_lengths.max())
    sums = np.zeros(len(dataset), dtype=np.float64)
    toks = np.zeros(len(dataset), dtype=np.int64)
    for lo in range(0, len(dataset), batch_size):
        idx = list(range(lo, min(lo + batch_size, len(dataset))))
        x, y = dataset.fetch_batch(idx, pad_to=pad_to)
        s, n = _per_row_nll_sums(model, cfg, x, y, attention_window)
        sums[lo : lo + len(idx)] = s.cpu().numpy().astype(np.float64)
        toks[lo : lo + len(idx)] = n.cpu().numpy().astype(np.int64)
    return sums, toks


def context_ablation(
    model: CodonGPT, cfg: CodonGPTConfig, dataset, windows=(1, 2, 4, None), **kwargs
) -> dict:
    """Test NLL by attention window."""
    return {
        str(w if w is not None else "full"): evaluate_perplexity(
            model, cfg, dataset, attention_window=w, **kwargs
        )
        for w in windows
    }


__all__ = ["context_ablation", "evaluate_perplexity", "per_row_model_nll"]
