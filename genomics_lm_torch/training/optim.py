"""Optimizer and LR schedules (twin of ``genomics_lm_tpu/training/optim.py``).

The JAX package builds an optax ``multi_transform`` over a label tree; here
one ``torch.optim.AdamW`` holds one parameter group per label:

- ``fast`` (``shape_proj``, ``offset_projs``, ``termination_head``):
  ``lr_embedding``, weight decay 0;
- ``base`` (every other parameter: biases, layer norms and embeddings
  included, exactly as JAX labels them): ``lr``, ``weight_decay``.

Optax's ``adamw`` and torch's ``AdamW`` are the same update: decoupled
decay of the pre-update parameter, bias-corrected moments, and ``eps``
outside the square root. The cosine multiplier is evaluated per applied
optimizer step, as optax counts its updates, and ``lr_scale`` multiplies
each group's lr for that step, which is torch's counterpart of the JAX
step's ``updates * lr_scale`` (it scales the decay step too, as there).

``resolve_warmup_steps``, ``cosine_lr_lambda``, ``PlateauScheduler`` and
``resolve_epochs`` are plain-Python copies. Not ported: Adafactor,
``freeze_backbone``, ``unfreeze_encoder`` and the LoRA groups, which raise
``NotImplementedError``, and ``grad_clip``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

FAST_GROUP_MARKERS = ("shape_proj", "offset_projs", "termination_head")


def resolve_warmup_steps(cfg: dict, total_steps: int) -> int:
    """Fixed or scheduler-relative warmup without ambiguous precedence."""
    if total_steps <= 0:
        raise ValueError("scheduler_total_steps must be positive")
    fraction = cfg.get("warmup_fraction")
    if fraction is None:
        steps = int(cfg.get("warmup_steps", 200))
        if steps < 0:
            raise ValueError("warmup_steps must be non-negative")
        return steps
    if "warmup_steps" in cfg:
        raise ValueError("configure only one of warmup_steps or warmup_fraction")
    fraction = float(fraction)
    if not 0.0 <= fraction < 1.0:
        raise ValueError("warmup_fraction must be in [0, 1)")
    if fraction == 0.0:
        return 0
    return max(1, int(round(total_steps * fraction)))


def cosine_lr_lambda(warmup_steps: int, total_steps: int, min_lr_ratio: float) -> Callable:
    """The reference cosine-with-warmup multiplier, on a Python step index."""
    warmup = max(1, warmup_steps)

    def lr_lambda(step_idx: int) -> float:
        if step_idx < warmup:
            return (step_idx + 1.0) / warmup
        progress = (step_idx - warmup) / max(1, total_steps - warmup)
        cosine = 0.5 * (1.0 + math.cos(math.pi * progress))
        return min_lr_ratio + (1 - min_lr_ratio) * cosine

    return lr_lambda


@dataclass
class PlateauScheduler:
    """Host-side ReduceLROnPlateau (mode=min, factor 0.5) with warmup.

    ``scale()`` is passed to the step as its ``lr_scale``.
    """

    base_lr: float
    min_lr: float = 1e-5
    factor: float = 0.5
    patience: int = 2
    warmup_steps: int = 0
    best: float = field(default=float("inf"))
    num_bad_epochs: int = 0
    current_scale: float = 1.0

    def scale(self, step: int) -> float:
        s = self.current_scale
        if self.warmup_steps > 0 and step < self.warmup_steps:
            s *= float(step + 1) / max(1, self.warmup_steps)
        return s

    def step_metric(self, metric: float) -> None:
        if metric < self.best:
            self.best = metric
            self.num_bad_epochs = 0
            return
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            floor = self.min_lr / self.base_lr if self.base_lr > 0 else 0.0
            self.current_scale = max(self.current_scale * self.factor, floor)
            self.num_bad_epochs = 0

    def state_dict(self) -> dict[str, Any]:
        return {
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "current_scale": self.current_scale,
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.best = float(state.get("best", float("inf")))
        self.num_bad_epochs = int(state.get("num_bad_epochs", 0))
        self.current_scale = float(state.get("current_scale", 1.0))


def param_group_labels(model: torch.nn.Module) -> dict[str, str]:
    """Label each parameter 'fast' | 'base' by its name, as JAX labels the
    leaves of its tree by path."""
    return {name: "fast" if any(m in name for m in FAST_GROUP_MARKERS) else "base"
            for name, _ in model.named_parameters()}


@dataclass
class OptimizerBundle:
    """AdamW with one group per label, and the schedule that drives its lr."""

    optimizer: torch.optim.Optimizer
    labels: dict[str, str]
    schedule_name: str  # "cosine" | "plateau"
    total_steps: int
    warmup_steps: int
    plateau: PlateauScheduler | None
    lr_lambda: Callable[[int], float] | None
    applied_steps: int = 0  # optimizer steps taken: the schedule's index

    def step(self, lr_scale: float = 1.0) -> None:
        """One AdamW step on the gradients in ``.grad``, at the group lrs of
        this step: base lr x schedule multiplier x ``lr_scale``."""
        mult = self.lr_lambda(self.applied_steps) if self.lr_lambda is not None else 1.0
        for group in self.optimizer.param_groups:
            group["lr"] = group["base_lr"] * mult * float(lr_scale)
        self.optimizer.step()
        self.applied_steps += 1


def build_optimizer(cfg: dict, model: torch.nn.Module, total_steps: int) -> OptimizerBundle:
    """AdamW in the fast and base groups from a flat run config."""
    for key in ("freeze_backbone", "unfreeze_encoder", "lora_rank", "lora_only"):
        if cfg.get(key):
            raise NotImplementedError(f"{key} is not ported")
    if str(cfg.get("optimizer", "adamw")).lower() == "adafactor":
        raise NotImplementedError("Adafactor is not ported")
    if cfg.get("grad_clip"):
        raise NotImplementedError("grad_clip is not ported")
    base_lr = float(cfg.get("lr", 5e-6))
    lr_embed = float(cfg.get("lr_embedding", base_lr))
    weight_decay = float(cfg.get("weight_decay", 0.05))
    min_lr = float(cfg.get("min_lr", 1e-5))
    scheduler_name = str(cfg.get("scheduler", "cosine")).lower()
    if scheduler_name not in {"cosine", "plateau"}:
        scheduler_name = "cosine"
    warmup_steps = resolve_warmup_steps(cfg, total_steps)

    if scheduler_name == "cosine":
        min_lr_ratio = (min_lr / base_lr) if base_lr > 0 else 0.0
        lr_lambda = cosine_lr_lambda(warmup_steps, total_steps, min_lr_ratio)
        plateau = None
    else:
        # plateau: the caller passes plateau.scale(step) as lr_scale
        lr_lambda = None
        plateau = PlateauScheduler(base_lr=base_lr, min_lr=min_lr,
                                   patience=int(cfg.get("plateau_patience", 2)),
                                   warmup_steps=warmup_steps)

    labels = param_group_labels(model)
    settings = {"fast": (lr_embed, 0.0), "base": (base_lr, weight_decay)}
    groups = []
    for label, (lr, wd) in settings.items():
        params = [p for name, p in model.named_parameters() if labels[name] == label]
        if params:
            groups.append({"params": params, "lr": lr, "base_lr": lr,
                           "weight_decay": wd, "label": label})
    optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
    return OptimizerBundle(optimizer=optimizer, labels=labels,
                           schedule_name=scheduler_name, total_steps=total_steps,
                           warmup_steps=warmup_steps, plateau=plateau,
                           lr_lambda=lr_lambda)


def resolve_epochs(cfg: dict, n_params: int, tokens_per_epoch: float) -> int:
    """``epochs: auto`` via the tokens-per-param heuristic (loop.py:745-759)."""
    epochs_cfg = cfg.get("epochs", 5)
    if isinstance(epochs_cfg, str) and epochs_cfg.strip().lower() == "auto":
        tokens_per_param = float(cfg.get("tokens_per_param", 20.0))
        tokens_target = max(1.0, tokens_per_param * float(n_params))
        per_epoch = max(1.0, float(tokens_per_epoch))
        est = int(math.ceil(tokens_target / per_epoch))
        est = max(
            int(cfg.get("epochs_min", 1)),
            min(est, int(cfg.get("epochs_max", max(1, est)))),
        )
        return est
    return int(epochs_cfg)


__all__ = [
    "FAST_GROUP_MARKERS",
    "OptimizerBundle",
    "PlateauScheduler",
    "build_optimizer",
    "cosine_lr_lambda",
    "param_group_labels",
    "resolve_epochs",
    "resolve_warmup_steps",
]
