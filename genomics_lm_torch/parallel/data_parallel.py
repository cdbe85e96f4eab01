"""Data parallelism across processes: the loss shares and the reductions.

JAX's step under a ``data`` mesh computes every loss as a mean over the
global microbatch's non-pad tokens: GSPMD reduces the sums and the counts
together. Ranks here hold different rows, and so different non-pad counts,
so a mean of per-rank means (DDP's gradient averaging) would weight a
row by its rank's count. Instead each rank scales each of its mean losses
by its share of that loss's global denominator (``loss_denominators``,
reduced once per group before the forward): the shares sum over the ranks
to the global mean, so do their gradients, and the step sums both
(``DPContext.all_reduce``). With one rank every scale is exactly 1, and
the collectives still run: a mesh over one rank drives the same code as
one over many.

A capped MoE layer routes over the global microbatch as JAX's does
(``models/codon_gpt.py::moe_route``): ``rows`` is the global microbatch's
row count while a training step runs (the step sets it), ``gather`` brings
every rank's per-row expert counts, and ``sum_with_grad`` sums the router
loss's statistics with their gradient.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from genomics_lm_torch.ops import losses as L
from genomics_lm_torch.ops.losses import PAD_ID
from genomics_lm_torch.parallel.launch import timed
from genomics_lm_torch.parallel.mesh import DATA_AXIS, Mesh


@dataclass
class DPContext:
    """The data axis seen from one rank: its group, index and size."""

    group: object
    rank: int
    size: int
    rows: int | None = None  # the global microbatch's rows while a step runs

    @classmethod
    def from_mesh(cls, mesh: Mesh | None) -> "DPContext | None":
        """The data axis of ``mesh``; None without a mesh over an
        initialized world (the one-process trainer) or a data axis."""
        group = mesh.group(DATA_AXIS) if mesh is not None else None
        if group is None:
            return None
        return cls(group, mesh.axis_rank(DATA_AXIS), mesh.axis_size(DATA_AXIS))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data axis, in place."""
        with timed(t.device, t.numel() * t.element_size()):
            dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order on a new leading axis."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        with timed(t.device, self.size * t.numel() * t.element_size(), "all-gather"):
            dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts)

    def sum_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data axis, differentiable: the gradient
        of every rank's loss with respect to the sum reaches each rank's
        ``t`` (an all-reduce backward)."""
        return _SumOverData.apply(t, self)


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, dp):
        fctx.dp = dp
        return dp.all_reduce(t.contiguous().clone())

    @staticmethod
    def backward(fctx, grad):
        return fctx.dp.all_reduce(grad.contiguous().clone()), None


def _weighted_count(valid: torch.Tensor, labels: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return valid.float().sum()
    w = torch.as_tensor(weights, dtype=torch.float32, device=labels.device)
    return torch.where(valid, w[labels.clamp_min(0)], 0.0).sum()


def loss_denominators(model_cfg, loss_cfg, yb: torch.Tensor) -> torch.Tensor:
    """The denominators of one microbatch's mean losses, in the order
    ``[next, one per multi-offset weight, termination]`` (those the config
    has): the class-weighted counts of the targets each loss averages over
    (``ops/losses.py::cross_entropy_parts``)."""
    lw = None if model_cfg.uniform_loss_weights else model_cfg.loss_weights
    out = [_weighted_count(yb != PAD_ID, yb, lw)]
    T = yb.shape[1]
    for offset, weight in loss_cfg.multi_offset_weights:
        if weight == 0.0 or offset <= 1 or offset > T:
            out.append(torch.zeros((), device=yb.device))
            continue
        target = yb[:, offset - 1:]
        valid = L.offset_target_mask(yb, offset) & (target != PAD_ID)
        out.append(_weighted_count(valid, target, lw))
    if loss_cfg.termination_enabled:
        labels = L.termination_distance_bucket_labels(
            yb, stop_ids=loss_cfg.termination_stop_ids,
            bucket_edges=loss_cfg.termination_bucket_edges)
        out.append(_weighted_count(labels != -100, labels, loss_cfg.termination_class_weights))
    return torch.stack(out).float()


def loss_scales(model_cfg, loss_cfg, y: torch.Tensor, dp: DPContext) -> torch.Tensor:
    """(G, terms) scales of a (G, B, T) group's mean losses: each rank's
    share of each global denominator (0 where no rank has a target)."""
    local = torch.stack([loss_denominators(model_cfg, loss_cfg, y[g])
                         for g in range(y.shape[0])])
    total = dp.all_reduce(local.clone())
    return torch.where(total > 0, local / total.clamp_min(1e-30), torch.zeros_like(local))


__all__ = ["DPContext", "loss_denominators", "loss_scales"]
