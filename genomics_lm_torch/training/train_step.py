"""Train and eval steps (twin of ``genomics_lm_tpu/training/train_step.py``).

The JAX step is one jitted program per accumulation group: ``lax.scan``
over the (G, B, T) microbatches accumulates float32 gradients and a
``lax.cond`` on an all-finite flag applies or skips the update. Here the
group is a Python loop of eager forward/backward passes, with the same
semantics:

- gradients are averaged over the microbatches whose loss is finite;
- any nonfinite microbatch loss aborts the whole group; finite
  microbatches before the first nonfinite one count as discarded;
- non-pad target tokens and the loss sums are credited only when the
  group commits.

Per microbatch, ``finite`` and every metric stay on the device
(``torch.where``); the group's one host read decides ``applied``, and the
optimizer steps only then. The metrics are 0-dim device tensors with the
JAX step's keys.

The auxiliary objectives (multi-offset, termination, replay), the MoE
router loss, shape guidance from a lookup table, remat and frozen labels
are not ported: ``composite_loss`` and ``make_train_step`` raise
``NotImplementedError`` for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.losses import PAD_ID
from genomics_lm_torch.training.optim import OptimizerBundle


@dataclass(frozen=True)
class LossConfig:
    """Which auxiliary losses the step adds (the JAX fields that enable them).

    None of them is ported, so the step raises when one is enabled; their
    weights, stop ids, buckets and class weights join this class when they
    are. The next-token loss takes its label smoothing from the model
    config, as in JAX.
    """

    multi_offset_weights: tuple[tuple[int, float], ...] = ()
    termination_enabled: bool = False
    replay_enabled: bool = False


def _check_ported(model_cfg: CodonGPTConfig, loss_cfg: LossConfig) -> None:
    if loss_cfg.multi_offset_weights:
        raise NotImplementedError("the multi-offset loss is not ported")
    if loss_cfg.termination_enabled:
        raise NotImplementedError("the termination loss is not ported")
    if loss_cfg.replay_enabled:
        raise NotImplementedError("the replay loss is not ported")
    if model_cfg.moe_experts:
        raise NotImplementedError("MoE MLP (moe_experts > 0) is not ported")


def composite_loss(model, model_cfg: CodonGPTConfig, loss_cfg: LossConfig,
                   xb: torch.Tensor, yb: torch.Tensor, *, train: bool,
                   generator: torch.Generator | None):
    """Total loss and its parts for one microbatch: the next-token CE."""
    _check_ported(model_cfg, loss_cfg)
    _, next_loss = codon_gpt.forward(model, model_cfg, xb, yb, train=train,
                                     generator=generator)
    return next_loss, {"next_loss": next_loss}


def _zeros_metrics(device) -> dict[str, torch.Tensor]:
    f32 = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
    return {
        "total_loss_sum": f32(),
        "next_loss_sum": f32(),
        "finite_microbatches": i32(),
        "nonpad_tokens": i32(),
        "first_loss": f32(),
        "discarded_before_nonfinite": i32(),
        "saw_nonfinite": torch.zeros((), dtype=torch.bool, device=device),
    }


def make_train_step(model_cfg: CodonGPTConfig, loss_cfg: LossConfig) -> Callable:
    """Build the group step::

        metrics = step(model, optimizer, batch, generator, lr_scale)

    ``batch`` holds ``x``/``y`` of shape (G, B, T) on the model's device
    (G = accumulation group size); ``optimizer`` is the ``OptimizerBundle``
    of ``build_optimizer``; ``generator`` (on the model's device, or None
    for no dropout) draws every dropout mask and attention seed. When the
    group commits, the parameters are updated and each ``.grad`` holds the
    averaged group gradient; when it aborts, ``.grad`` is None.
    """
    _check_ported(model_cfg, loss_cfg)
    if model_cfg.use_checkpoint:
        raise NotImplementedError("remat (use_checkpoint) is not ported")

    def step(model: torch.nn.Module, optimizer: OptimizerBundle, batch: dict,
             generator: torch.Generator | None, lr_scale: float = 1.0) -> dict:
        x, y = batch["x"], batch["y"]
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None  # an aborted group leaves no gradient behind
        device = x.device
        sizes = [p.numel() for p in params]
        grads_acc = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
        metrics = _zeros_metrics(device)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        for g in range(x.shape[0]):
            xb, yb = x[g], y[g]
            loss, parts = composite_loss(model, model_cfg, loss_cfg, xb, yb, train=True,
                                         generator=generator)
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
            finite = torch.isfinite(loss)
            flat = torch.cat([gr.reshape(-1).float() for gr in grads])
            grads_acc += torch.where(finite, flat, zero)
            first = metrics["finite_microbatches"] == 0
            metrics["total_loss_sum"] += torch.where(finite, loss.detach(), zero)
            metrics["next_loss_sum"] += torch.where(finite, parts["next_loss"].detach(), zero)
            metrics["first_loss"] = torch.where(finite & first, loss.detach(),
                                                metrics["first_loss"])
            metrics["finite_microbatches"] += finite.int()
            metrics["nonpad_tokens"] += torch.where(finite, (yb != PAD_ID).sum().int(), 0)
            metrics["discarded_before_nonfinite"] += (finite & ~metrics["saw_nonfinite"]).int()
            metrics["saw_nonfinite"] |= ~finite

        grads_finite = torch.isfinite(grads_acc).all()
        group_ok = (~metrics["saw_nonfinite"]) & grads_finite & (
            metrics["finite_microbatches"] > 0)
        if bool(group_ok):  # the group's one host read
            grads_acc /= metrics["finite_microbatches"].clamp_min(1).float()
            for p, gr in zip(params, torch.split(grads_acc, sizes)):
                p.grad = gr.view_as(p)
            optimizer.step(lr_scale)
        metrics["applied"] = group_ok
        # an abort discards the whole group's tokens and metrics
        for key in ("total_loss_sum", "next_loss_sum"):
            metrics[key] = torch.where(group_ok, metrics[key], zero)
        none = torch.zeros((), dtype=torch.int32, device=device)
        metrics["committed_microbatches"] = torch.where(
            group_ok, metrics["finite_microbatches"], none)
        metrics["nonpad_tokens"] = torch.where(group_ok, metrics["nonpad_tokens"], none)
        return metrics

    return step


def make_eval_step(model_cfg: CodonGPTConfig, loss_cfg: LossConfig) -> Callable:
    """Validation step over one (B, T) batch: loss parts and counts."""
    _check_ported(model_cfg, loss_cfg)

    @torch.no_grad()
    def step(model: torch.nn.Module, xb: torch.Tensor, yb: torch.Tensor) -> dict:
        total, parts = composite_loss(model, model_cfg, loss_cfg, xb, yb, train=False,
                                      generator=None)
        nonpad = (yb != PAD_ID).sum()
        return {
            "total_loss": total,
            "next_loss": parts["next_loss"],
            "nonpad_tokens": nonpad.int(),
            # token-weighted CE sum for exact corpus perplexity
            "next_loss_token_sum": parts["next_loss"] * nonpad.float(),
        }

    return step


__all__ = ["LossConfig", "composite_loss", "make_eval_step", "make_train_step"]
