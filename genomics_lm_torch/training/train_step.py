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

``composite_loss`` is the JAX one: CE + the weighted multi-offset CEs +
termination weight x bucket CE, and on the microbatches the loop flags,
replay weight x the termination CE of a replay batch's forward. JAX reuses
the microbatch's key for the replay forward; here the replay forward draws
its dropout from the same generator after the main one. With a shape
lookup table and an attached encoder, each microbatch's codon one-hots go
through the encoder into the model's shape guidance. Frozen parameters
(``requires_grad=False``, set by ``build_optimizer``) get no gradient,
remat is the model's (``cfg.use_checkpoint``), and ``grad_clip`` is the
optimizer's. A MoE model adds ``moe_aux_weight`` x its router
load-balancing loss (the forward's ``moe_aux_loss``, the mean over
layers) in training only, as ``parts["moe_aux"]``; evaluation losses stay
pure cross-entropy.

Data parallelism (``dp``, ``parallel/data_parallel.py``): every rank runs
its rows of the global microbatch, each of its mean losses scaled by its
share of that loss's global denominator, so the shares and their
gradients sum over the ranks to JAX's global-microbatch values. One
reduction before the group's forwards carries the denominators, one after
them the per-microbatch losses and counts, and one the accumulated
gradient; the nonfinite abort is then one decision over all ranks. A
MoE model's capped layers route over the global microbatch (each block's
``moe_dp``, set by the step; ``batch["rows"]``, when given, is the global
microbatch's row count, else every rank's rows are real), and the router
loss enters each rank's loss as its 1/dp share. Under
tensor parallelism (``model.tp``) the gradients of the replicated
parameters that each rank sees only in part (``tp_partial_grad``) are
summed over the model axis too. The reductions run unconditionally, so
every rank issues the same collectives whatever its data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.biophysics import encode
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops import losses as L
from genomics_lm_torch.ops.losses import PAD_ID
from genomics_lm_torch.parallel.data_parallel import DPContext, loss_scales
from genomics_lm_torch.parallel.launch import timed
from genomics_lm_torch.parallel.sharding import tp_partial_grad
from genomics_lm_torch.training.optim import OptimizerBundle


@dataclass(frozen=True)
class LossConfig:
    """Static auxiliary-loss configuration of the step (the JAX class)."""

    multi_offset_weights: tuple[tuple[int, float], ...] = ()
    label_smoothing: float = 0.0
    termination_enabled: bool = False
    termination_weight: float = 1.0
    termination_stop_ids: tuple[int, ...] = ()
    termination_bucket_edges: tuple[int, ...] = (0, 3, 10, 30)
    replay_enabled: bool = False
    replay_weight: float = 1.0
    termination_class_weights: tuple[float, ...] | None = None
    replay_class_weights: tuple[float, ...] | None = None

    @classmethod
    def from_run_config(cls, cfg: dict, stop_ids: tuple[int, ...]) -> "LossConfig":
        offsets = cfg.get("multi_offset_weights") or {}
        term_cw = cfg.get("termination_class_weights")
        replay_cw = cfg.get("replay_class_weights")
        return cls(
            multi_offset_weights=tuple(sorted((int(k), float(v)) for k, v in offsets.items())),
            label_smoothing=float(cfg.get("label_smoothing", 0.0)),
            termination_enabled=bool(cfg.get("termination_loss_enabled", False)),
            termination_weight=float(cfg.get("termination_loss_weight", 1.0)),
            termination_stop_ids=tuple(cfg.get("termination_stop_ids", stop_ids)),
            termination_bucket_edges=tuple(cfg.get("termination_bucket_edges", (0, 3, 10, 30))),
            replay_enabled=bool(cfg.get("replay_loss_enabled", False)),
            replay_weight=float(cfg.get("replay_loss_weight", 1.0)),
            termination_class_weights=tuple(term_cw) if term_cw else None,
            replay_class_weights=tuple(replay_cw) if replay_cw else None,
        )


def _class_weights(weights, device) -> torch.Tensor | None:
    return torch.tensor(weights, dtype=torch.float32, device=device) if weights else None


def _shape_embeddings_for(model, xb: torch.Tensor, shape_lookup: torch.Tensor | None):
    """Token batch → codon-aligned DNA-shape features through the attached
    encoder: the 3 nucleotide one-hots of every token, then ``encode``."""
    encoder = model._modules.get("shape_encoder")
    if shape_lookup is None or encoder is None:
        return None
    B, T = xb.shape
    return encode(encoder, shape_lookup[xb].reshape(B, 3 * T, 4))


def replay_loss(model, model_cfg: CodonGPTConfig, loss_cfg: LossConfig,
                replay: tuple[torch.Tensor, torch.Tensor], *, train: bool,
                generator: torch.Generator | None) -> torch.Tensor:
    """The termination CE of a replay batch's forward (no shape guidance)."""
    replay_x, replay_labels = replay
    _, _, aux = codon_gpt.forward(model, model_cfg, replay_x, None, train=train,
                                  generator=generator, return_aux=True)
    return L.termination_aux_loss(
        aux["termination_logits"], replay_labels,
        class_weights=_class_weights(loss_cfg.replay_class_weights, replay_x.device))


def composite_loss(model, model_cfg: CodonGPTConfig, loss_cfg: LossConfig,
                   xb: torch.Tensor, yb: torch.Tensor, *, train: bool,
                   generator: torch.Generator | None,
                   replay: tuple[torch.Tensor, torch.Tensor] | None = None,
                   shape_embeddings: torch.Tensor | None = None,
                   shape_lookup: torch.Tensor | None = None,
                   scales: torch.Tensor | None = None):
    """Total loss and its parts for one microbatch (the JAX ``composite_loss``).

    ``scales`` (``parallel/data_parallel.py::loss_scales``, one row) turns
    each mean loss into this rank's share of the global one, parts and
    total alike."""
    if shape_embeddings is None:
        shape_embeddings = _shape_embeddings_for(model, xb, shape_lookup)
    logits, next_loss, aux = codon_gpt.forward(
        model, model_cfg, xb, yb, train=train, generator=generator, return_aux=True,
        shape_embeddings=shape_embeddings)
    if scales is not None:
        next_loss = next_loss * scales[0]
    total = next_loss
    parts: dict = {"next_loss": next_loss}

    if model_cfg.moe_experts and train:
        # the Switch router load-balancing loss, in training only
        parts["moe_aux"] = aux["moe_aux_loss"]
        total = total + model_cfg.moe_aux_weight * parts["moe_aux"]

    if loss_cfg.multi_offset_weights:
        lw = (None if model_cfg.uniform_loss_weights
              else torch.tensor(model_cfg.loss_weights, dtype=torch.float32,
                                device=xb.device))
        offset_total, offset_losses = L.multi_offset_lm_loss(
            aux.get("offset_logits", logits), yb, dict(loss_cfg.multi_offset_weights),
            label_smoothing=loss_cfg.label_smoothing, loss_weights=lw)
        if scales is not None:
            column = {o: 1 + i for i, (o, _) in enumerate(loss_cfg.multi_offset_weights)}
            offset_losses = {o: v * scales[column[o]] for o, v in offset_losses.items()}
            offset_total = torch.zeros((), dtype=torch.float32, device=yb.device)
            for o, w in sorted(loss_cfg.multi_offset_weights):
                if o in offset_losses:
                    offset_total = offset_total + float(w) * offset_losses[o]
        total = total + offset_total
        parts["offset_losses"] = offset_losses

    if loss_cfg.termination_enabled:
        term_labels = L.termination_distance_bucket_labels(
            yb, stop_ids=loss_cfg.termination_stop_ids,
            bucket_edges=loss_cfg.termination_bucket_edges)
        term_loss = L.termination_aux_loss(
            aux["termination_logits"], term_labels,
            class_weights=_class_weights(loss_cfg.termination_class_weights, xb.device))
        if scales is not None:
            term_loss = term_loss * scales[-1]
        total = total + loss_cfg.termination_weight * term_loss
        parts["term_loss"] = term_loss

    if loss_cfg.replay_enabled and replay is not None:
        rl = replay_loss(model, model_cfg, loss_cfg, replay, train=train,
                         generator=generator)
        total = total + loss_cfg.replay_weight * rl
        parts["replay_loss"] = rl

    return total, parts


def _zeros_metrics(loss_cfg: LossConfig, device) -> dict[str, torch.Tensor]:
    f32 = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
    m = {
        "total_loss_sum": f32(),
        "next_loss_sum": f32(),
        "finite_microbatches": i32(),
        "nonpad_tokens": i32(),
        "first_loss": f32(),
        "discarded_before_nonfinite": i32(),
        "saw_nonfinite": torch.zeros((), dtype=torch.bool, device=device),
    }
    for offset, _ in loss_cfg.multi_offset_weights:
        m[f"offset_{offset}_sum"] = f32()
    if loss_cfg.termination_enabled:
        m["term_loss_sum"] = f32()
    if loss_cfg.replay_enabled:
        m["replay_loss_sum"] = f32()
        m["replay_count"] = i32()
    return m


def _metric_rows(loss_cfg: LossConfig) -> list[str]:
    """The per-microbatch values a group records, in one tensor's rows."""
    rows = ["loss", "next_loss", "nonpad"]
    rows += [f"offset_{o}" for o, _ in loss_cfg.multi_offset_weights]
    if loss_cfg.termination_enabled:
        rows.append("term_loss")
    if loss_cfg.replay_enabled:
        rows += ["replay_loss", "replay_on"]
    return rows


def _trainable(model) -> tuple[list, int]:
    """The trainable parameters, those whose gradient is a partial sum over
    the model axis first, and how many those are."""
    tp = getattr(model, "tp", None)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if tp is None:
        return [p for _, p in named], 0
    partial = [p for n, p in named
               if tp_partial_grad(n, tp.layout, sequence_parallel=tp.sequence_parallel)]
    ids = {id(p) for p in partial}
    return partial + [p for _, p in named if id(p) not in ids], len(partial)


def make_train_step(model_cfg: CodonGPTConfig, loss_cfg: LossConfig, *,
                    use_replay: bool = False,
                    shape_lookup: torch.Tensor | None = None,
                    dp: DPContext | None = None) -> Callable:
    """Build the group step::

        metrics = step(model, optimizer, batch, generator, lr_scale)

    ``batch`` holds ``x``/``y`` of shape (G, B, T) on the model's device
    (G = accumulation group size) and, with ``use_replay``, ``replay_x``/
    ``replay_labels`` (one replay batch, on the device) and ``replay_mask``
    (G host booleans: the microbatches that add the replay loss);
    ``optimizer`` is the ``OptimizerBundle`` of ``build_optimizer``;
    ``generator`` (on the model's device, or None for no dropout) draws
    every dropout mask and attention seed. ``shape_lookup`` (the (V, 3, 4)
    table of ``biophysics.shape_lookup_table`` on the device) feeds the
    model's shape encoder. With ``dp`` the rows are this rank's part of
    each global microbatch and the metrics are the global ones. When the
    group commits, the parameters are updated and each trainable ``.grad``
    holds the averaged group gradient (clipped, under ``grad_clip``); when
    it aborts, ``.grad`` is None.
    """
    rows = _metric_rows(loss_cfg)
    at = {name: i for i, name in enumerate(rows)}

    def step(model: torch.nn.Module, optimizer: OptimizerBundle, batch: dict,
             generator: torch.Generator | None, lr_scale: float = 1.0) -> dict:
        x, y = batch["x"], batch["y"]
        params, n_partial = _trainable(model)
        for p in params:
            p.grad = None  # an aborted group leaves no gradient behind
        device = x.device
        sizes = [p.numel() for p in params]
        grads_acc = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        G = x.shape[0]
        scales = loss_scales(model_cfg, loss_cfg, y, dp) if dp is not None else None
        if dp is not None and model_cfg.moe_experts:
            dp.rows = int(batch.get("rows", x.shape[1] * dp.size))
            for block in model.blocks:
                block.moe_dp = dp
        values = torch.zeros((len(rows), G), dtype=torch.float32, device=device)
        for g in range(G):
            xb, yb = x[g], y[g]
            loss, parts = composite_loss(model, model_cfg, loss_cfg, xb, yb, train=True,
                                         generator=generator, shape_lookup=shape_lookup,
                                         scales=None if scales is None else scales[g])
            with_replay = use_replay and bool(batch["replay_mask"][g])
            if with_replay:
                # only on flagged microbatches, as the JAX step's cond
                rl = replay_loss(model, model_cfg, loss_cfg,
                                 (batch["replay_x"], batch["replay_labels"]), train=True,
                                 generator=generator)
                loss = loss + loss_cfg.replay_weight * rl
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
            finite = torch.isfinite(loss)
            flat = torch.cat([gr.reshape(-1).float() for gr in grads])
            grads_acc += torch.where(finite, flat, zero)
            col = [loss.detach(), parts["next_loss"].detach(), (yb != PAD_ID).sum().float()]
            for offset, _ in loss_cfg.multi_offset_weights:
                # the loss skips zero-weight / out-of-range offsets
                col.append(parts["offset_losses"].get(offset, zero).detach())
            if loss_cfg.termination_enabled:
                col.append(parts["term_loss"].detach())
            if loss_cfg.replay_enabled:
                col += [rl.detach(), torch.ones_like(zero)] if with_replay else [zero, zero]
            values[:, g] = torch.stack(col)
        if dp is not None:
            dp.all_reduce(values)
            dp.all_reduce(grads_acc)
        tp = getattr(model, "tp", None)
        if n_partial and tp is not None:
            with timed(device, 4 * sum(sizes[:n_partial])):  # a view of grads_acc
                torch.distributed.all_reduce(grads_acc[: sum(sizes[:n_partial])],
                                             group=tp.group)

        metrics = _zeros_metrics(loss_cfg, device)
        for g in range(G):
            loss = values[at["loss"], g]
            finite = torch.isfinite(loss)
            first = metrics["finite_microbatches"] == 0
            metrics["total_loss_sum"] += torch.where(finite, loss, zero)
            metrics["next_loss_sum"] += torch.where(finite, values[at["next_loss"], g], zero)
            metrics["first_loss"] = torch.where(finite & first, loss, metrics["first_loss"])
            metrics["finite_microbatches"] += finite.int()
            metrics["nonpad_tokens"] += torch.where(finite, values[at["nonpad"], g].int(), 0)
            metrics["discarded_before_nonfinite"] += (finite & ~metrics["saw_nonfinite"]).int()
            metrics["saw_nonfinite"] |= ~finite
            for offset, _ in loss_cfg.multi_offset_weights:
                metrics[f"offset_{offset}_sum"] += torch.where(
                    finite, values[at[f"offset_{offset}"], g], zero)
            if loss_cfg.termination_enabled:
                metrics["term_loss_sum"] += torch.where(finite, values[at["term_loss"], g],
                                                        zero)
            if loss_cfg.replay_enabled:
                rl = values[at["replay_loss"], g]
                has_rl = (values[at["replay_on"], g] > 0) & finite & torch.isfinite(rl)
                metrics["replay_loss_sum"] += torch.where(has_rl, rl, zero)
                metrics["replay_count"] += has_rl.int()

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


def make_eval_step(model_cfg: CodonGPTConfig, loss_cfg: LossConfig, *,
                   shape_lookup: torch.Tensor | None = None,
                   dp: DPContext | None = None) -> Callable:
    """Validation step over one (B, T) batch: loss parts and counts. With
    ``dp`` the batch is this rank's part of a global one, and the outputs
    are the global batch's."""

    @torch.no_grad()
    def step(model: torch.nn.Module, xb: torch.Tensor, yb: torch.Tensor) -> dict:
        scales = loss_scales(model_cfg, loss_cfg, yb[None], dp)[0] if dp is not None else None
        total, parts = composite_loss(model, model_cfg, loss_cfg, xb, yb, train=False,
                                      generator=None, shape_lookup=shape_lookup,
                                      scales=scales)
        out = {
            "total_loss": total,
            "next_loss": parts["next_loss"],
            "nonpad_tokens": (yb != PAD_ID).sum().float(),
        }
        for offset, _ in loss_cfg.multi_offset_weights:
            out[f"offset_{offset}"] = parts["offset_losses"].get(
                offset, torch.zeros((), dtype=torch.float32, device=xb.device))
        if loss_cfg.termination_enabled:
            out["term_loss"] = parts["term_loss"]
        if dp is not None:
            reduced = dp.all_reduce(torch.stack(list(out.values())))
            out = dict(zip(out, reduced.unbind()))
        # token-weighted CE sum for exact corpus perplexity
        out["next_loss_token_sum"] = out["next_loss"] * out["nonpad_tokens"]
        out["nonpad_tokens"] = out["nonpad_tokens"].int()
        return out

    return step


__all__ = ["LossConfig", "composite_loss", "make_eval_step", "make_train_step",
           "replay_loss"]
