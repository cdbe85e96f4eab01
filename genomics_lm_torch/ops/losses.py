"""Cross-entropy with torch's weighted-mean semantics, in float32.

Twin of ``genomics_lm_tpu/ops/losses.py``: the reference computes
``F.cross_entropy(logits.float(), targets, ignore_index=0,
label_smoothing=eps, weight=w)``, whose reduction is a *weighted* mean:
each sample is scaled by the weight of its true class and the sum is
divided by the sum of those weights over the samples that are not
ignored. With label smoothing the target distribution is
``(1 - eps) * one_hot + eps / C``, the class weight multiplies inside the
smoothing sum, and the denominator is still indexed by the hard label.

The multi-offset, termination and replay objectives
(``multi_offset_lm_loss``, ``termination_*``, ``offset_target_mask``) are
not ported; ``training/train_step.py::composite_loss`` raises for them.
"""

from __future__ import annotations

import torch

PAD_ID = 0


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    ignore_index: int | None = PAD_ID,
    label_smoothing: float = 0.0,
    weight: torch.Tensor | None = None,
    valid_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Torch-semantics mean cross-entropy over flattened positions.

    logits: (..., C); targets: (...) int. ``valid_mask`` (same shape as
    targets) composes with ``ignore_index``: both exclude positions from
    the numerator and the denominator.
    """
    numer, denom = cross_entropy_parts(
        logits, targets, ignore_index=ignore_index,
        label_smoothing=label_smoothing, weight=weight, valid_mask=valid_mask,
    )
    return numer / torch.clamp_min(denom, 1e-12)


def cross_entropy_parts(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    ignore_index: int | None = PAD_ID,
    label_smoothing: float = 0.0,
    weight: torch.Tensor | None = None,
    valid_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of the weighted-mean cross-entropy.

    Summing the parts over microbatches and dividing once reproduces the
    whole-batch mean exactly, which a mean of means does not.
    """
    C = logits.shape[-1]
    logits = logits.float().reshape(-1, C)
    targets = targets.reshape(-1).long()

    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, 1, targets[:, None])[:, 0]
    nll = logz - true_logit
    eps = float(label_smoothing)

    if weight is not None:
        w_cls = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
        w = w_cls[targets]
    else:
        w_cls = None
        w = torch.ones_like(nll)

    # per-sample loss_i = -sum_j q_j * w_j * log p_j with q = (1-eps)*one_hot
    # + eps/C: the class weight sits inside the smoothing sum, and the
    # denominator is sum_i w_{y_i} over the valid samples
    if eps > 0.0:
        if w_cls is None:
            smooth = logz - logits.mean(dim=-1)
            loss = (1.0 - eps) * nll + eps * smooth
        else:
            smooth = (logz * w_cls.sum() - logits @ w_cls) / float(C)
            loss = (1.0 - eps) * w * nll + eps * smooth
            w = torch.ones_like(nll)  # the weights are already folded in
    else:
        loss = nll

    valid = torch.ones_like(targets, dtype=torch.bool)
    if ignore_index is not None:
        valid = valid & (targets != ignore_index)
    if valid_mask is not None:
        valid = valid & valid_mask.reshape(-1).bool()

    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    if w_cls is not None:
        denom = torch.where(valid, w_cls[targets], zero).sum()
    else:
        denom = valid.float().sum()
    numer = torch.where(valid, loss * w, zero).sum()
    return numer, denom


__all__ = ["PAD_ID", "cross_entropy", "cross_entropy_parts"]
