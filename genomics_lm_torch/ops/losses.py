"""Cross-entropy with torch's weighted-mean semantics, in float32.

Twin of ``genomics_lm_tpu/ops/losses.py``: the reference computes
``F.cross_entropy(logits.float(), targets, ignore_index=0,
label_smoothing=eps, weight=w)``, whose reduction is a *weighted* mean:
each sample is scaled by the weight of its true class and the sum is
divided by the sum of those weights over the samples that are not
ignored. With label smoothing the target distribution is
``(1 - eps) * one_hot + eps / C``, the class weight multiplies inside the
smoothing sum, and the denominator is still indexed by the hard label.

Also the multi-offset and termination auxiliary objectives
(``offset_target_mask``, ``multi_offset_lm_loss``,
``termination_distance_bucket_labels``, ``termination_aux_loss``), which
the replay loss reuses.
"""

from __future__ import annotations

import torch

PAD_ID = 0
DEFAULT_BOUNDARY_IDS = (2, 3)  # <EOS_CDS>, <SEP>


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


def offset_target_mask(yb: torch.Tensor, offset: int,
                       boundary_ids=DEFAULT_BOUNDARY_IDS) -> torch.Tensor:
    """Valid positions for predicting seq[t + offset] from logits at t.

    A target is invalid if it is PAD or if reaching it from t would cross an
    earlier EOS/SEP boundary (the target being a boundary is allowed).
    Returns (B, T - offset + 1) bool.
    """
    if offset < 1:
        raise ValueError("offset must be >= 1")
    B, T = yb.shape
    if offset > T:
        return torch.zeros((B, 0), dtype=torch.bool, device=yb.device)
    target = yb[:, offset - 1:]
    valid = target != PAD_ID
    boundary = torch.zeros_like(yb, dtype=torch.bool)
    for bid in boundary_ids:
        boundary |= yb == int(bid)
    width = target.shape[1]
    for shift in range(offset - 1):
        valid &= ~boundary[:, shift:shift + width]
    return valid


def multi_offset_lm_loss(
    logits,
    yb: torch.Tensor,
    offset_weights: dict[int, float],
    *,
    label_smoothing: float = 0.0,
    loss_weights: torch.Tensor | None = None,
    boundary_ids=DEFAULT_BOUNDARY_IDS,
):
    """Weighted sum of per-offset CE losses over boundary-respecting targets.

    ``logits`` is either a single (B, T, C) tensor (shared head) or a dict
    ``{offset: (B, T, C)}`` from per-offset heads. Offsets <= 1 or beyond the
    sequence are skipped; an offset with no valid target contributes 0.
    """
    total = torch.zeros((), dtype=torch.float32, device=yb.device)
    losses: dict[int, torch.Tensor] = {}
    T = yb.shape[1]
    for offset, weight in sorted(offset_weights.items()):
        if weight == 0.0 or offset <= 1 or offset > T:
            continue
        target = yb[:, offset - 1:]
        if isinstance(logits, dict):
            if offset not in logits:
                continue
            pred = logits[offset][:, :target.shape[1], :]
        else:
            pred = logits[:, :target.shape[1], :]
        valid = offset_target_mask(yb, offset, boundary_ids=boundary_ids)
        offset_loss = cross_entropy(pred, target, ignore_index=PAD_ID,
                                    label_smoothing=label_smoothing, weight=loss_weights,
                                    valid_mask=valid)
        offset_loss = torch.where(valid.any(), offset_loss, torch.zeros_like(offset_loss))
        losses[offset] = offset_loss
        total = total + float(weight) * offset_loss
    return total, losses


def termination_distance_bucket_labels(
    yb: torch.Tensor,
    stop_ids: tuple[int, ...],
    bucket_edges: tuple[int, ...] = (0, 3, 10, 30),
    ignore_index: int = -100,
) -> torch.Tensor:
    """Bucket each position's distance to the next stop token: positions
    after the last stop get the final bucket; PAD positions get
    ``ignore_index``."""
    if not stop_ids:
        raise ValueError("stop_ids must not be empty")
    if tuple(bucket_edges) != tuple(sorted(bucket_edges)):
        raise ValueError("bucket_edges must be sorted")
    B, T = yb.shape
    positions = torch.arange(T, device=yb.device).expand(B, T)
    stop_mask = torch.isin(yb, torch.tensor(stop_ids, dtype=yb.dtype, device=yb.device))
    stop_positions = torch.where(stop_mask, positions, T)
    # next stop at or after each position: reversed running minimum
    next_stop = torch.flip(torch.cummin(torch.flip(stop_positions, [1]), dim=1).values, [1])
    distances = next_stop - positions
    edges = torch.tensor(bucket_edges, dtype=distances.dtype, device=yb.device)
    labels = (distances[:, :, None] > edges[None, None, :]).sum(dim=-1)
    labels = torch.where(next_stop == T, len(bucket_edges), labels)
    return torch.where(yb == PAD_ID, ignore_index, labels)


def termination_aux_loss(
    termination_logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor | None = None,
    ignore_index: int = -100,
) -> torch.Tensor:
    """f32 CE over bucket labels, ignoring ``ignore_index`` positions."""
    # ignored labels are clamped into range before the gather; they are masked out
    safe = torch.where(labels == ignore_index, 0, labels)
    return cross_entropy(termination_logits, safe, ignore_index=None, weight=class_weights,
                         valid_mask=labels != ignore_index)


__all__ = [
    "DEFAULT_BOUNDARY_IDS",
    "PAD_ID",
    "cross_entropy",
    "cross_entropy_parts",
    "multi_offset_lm_loss",
    "offset_target_mask",
    "termination_aux_loss",
    "termination_distance_bucket_labels",
]
