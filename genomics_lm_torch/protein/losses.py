"""Multi-task critic losses and class-weight policies (twin of
``genomics_lm_tpu/protein/losses.py``).

Classification cross-entropy with ignore label -1 and sqrt-inverse-frequency
class weights (clamped, from the train split only), multi-label BCE with an
automatic ``pos_weight``, NaN-masked smooth-L1 stability regression, and the
opt-in saliency term that pulls attention-pool mass onto catalytic motifs.
The class-weight policies and the motif mask are numpy (host) code, copied;
the losses are torch, each returning 0 when no sample is valid.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from genomics_lm_torch.ops.losses import cross_entropy


def sqrt_inverse_frequency_weights(
    labels: np.ndarray, n_classes: int, *, clamp_max: float = 10.0
) -> np.ndarray:
    """w_c = sqrt(N / count_c), normalized to mean 1, clamped."""
    labels = np.asarray(labels)
    labels = labels[labels >= 0]
    counts = np.bincount(labels, minlength=n_classes).astype(np.float64)
    weights = np.sqrt(labels.size / np.maximum(counts, 1.0))
    weights = weights / max(weights.mean(), 1e-12)
    return np.minimum(weights, clamp_max).astype(np.float32)


def classification_loss(logits, labels, class_weights=None):
    """CE over valid (label >= 0) samples; 0 when none are valid."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    loss = cross_entropy(logits, safe, ignore_index=None, weight=class_weights,
                         valid_mask=valid)
    return torch.where(valid.any(), loss, torch.zeros_like(loss)), valid.sum()


def multilabel_bce_loss(logits, targets, pos_weight=None):
    """Mean BCE-with-logits; optional per-class positive weighting."""
    pos = targets * F.logsigmoid(logits)
    if pos_weight is not None:
        pos = pos * pos_weight
    return -torch.mean(pos + (1.0 - targets) * F.logsigmoid(-logits))


def auto_pos_weight(targets: np.ndarray, *, clamp_max: float = 20.0) -> np.ndarray:
    """neg/pos ratio per class (torch BCEWithLogitsLoss pos_weight policy)."""
    targets = np.asarray(targets)
    pos = targets.sum(axis=0)
    neg = targets.shape[0] - pos
    return np.minimum(neg / np.maximum(pos, 1.0), clamp_max).astype(np.float32)


def smooth_l1_nan_masked(pred, target, beta: float = 1.0):
    """Smooth-L1 over non-NaN targets; 0 when all targets are NaN."""
    valid = ~torch.isnan(target)
    t = torch.where(valid, target, torch.zeros_like(target))
    diff = torch.abs(pred - t)
    loss = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)
    denom = torch.clamp_min(valid.sum(), 1)
    total = torch.where(valid, loss, torch.zeros_like(loss)).sum() / denom
    return torch.where(valid.any(), total, torch.zeros_like(total)), valid.sum()


# Catalytic motifs whose residues the critic's attention should cover
# (reference train_multi_task.py:580-605; "DXD" is the literal string).
CATALYTIC_MOTIFS = ("GDSGG", "HIGH", "KMSKS", "DXD")


def motif_position_mask(
    sequences, width: int, *, motifs=CATALYTIC_MOTIFS, token_offset: int = 1
) -> np.ndarray:
    """(B, width) float mask of token positions inside known motifs.

    Host-side string matching over the raw sequences. ``token_offset``
    accounts for the BOS token (residue i → token i+1); only each motif's
    first occurrence counts, matching the reference.
    """
    mask = np.zeros((len(sequences), width), np.float32)
    for row, seq in enumerate(sequences):
        for motif in motifs:
            hit = seq.find(motif)
            if hit < 0:
                continue
            lo = hit + token_offset
            hi = min(lo + len(motif), width)
            if lo < width:
                mask[row, lo:hi] = 1.0
    return mask


def saliency_regularizer(attn_weights, motif_mask):
    """-log of the attention mass on motif positions, averaged over the
    sequences that contain any motif (0.0 when none do). The mask is data,
    so the gradient flows only through ``attn_weights`` at motif positions
    of motif-bearing rows."""
    attn_weights = attn_weights.float()
    motif_mask = motif_mask.float()
    has_motif = motif_mask.sum(dim=1) > 0
    per_seq = -torch.log((attn_weights * motif_mask).sum(dim=1) + 1e-8)
    count = has_motif.sum()
    total = torch.where(has_motif, per_seq, torch.zeros_like(per_seq)).sum()
    mean = total / torch.clamp_min(count, 1)
    return torch.where(count > 0, mean, torch.zeros_like(mean))


__all__ = [
    "CATALYTIC_MOTIFS",
    "auto_pos_weight",
    "classification_loss",
    "motif_position_mask",
    "multilabel_bce_loss",
    "saliency_regularizer",
    "smooth_l1_nan_masked",
    "sqrt_inverse_frequency_weights",
]
