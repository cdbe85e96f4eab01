"""Model-agnostic training engine: Task / Strategy / Callback protocols (twin
of ``genomics_lm_tpu/training/engine.py``, the same names, events and
checkpoint envelope).

The protocols make the engine testable without real models: fake tasks
inject NaN batches, fake wall timers expire on demand, recorder callbacks
assert event streams.

- ``EngineState``: completed_epochs / current_epoch / microbatch /
  optimizer_step.
- ``TrainingCheckpoint``: the versioned envelope ``{engine, task, strategy,
  rng, metadata}``; another contract version is refused.
- ``TrainingTask``: yields batches and returns ``(loss, grads)`` from
  ``training_step``. As in JAX the task hands its gradients back instead of
  leaving them in ``.grad``: a torch task computes them with
  ``torch.autograd.grad``. ``grads`` is a tensor or a dict, list or tuple
  of tensors.
- ``AccumulatedGradsStrategy``: sums each group's gradients into tensors it
  owns, averages them by the microbatches actually processed, gates the
  commit on every gradient being finite (one device read for the whole
  tree), clips by the global norm (floor 1e-12) on the device, and hands
  the result to the task's ``apply_updates``.
- ``TrainingEngine.fit``: the epoch loop, group commits, the abort of a
  group with a nonfinite microbatch and the skip to that group's end,
  ``max_aborted_groups`` (a ``nonfinite_group_limit`` save, then the error),
  mid-epoch resume by fast-forwarding the iterator, periodic and wall-time
  saves, and the weighted validation average. Events: ``group_committed``,
  ``group_aborted``, ``validation_completed``, ``epoch_completed``,
  ``checkpoint_saved``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Protocol, runtime_checkable

import numpy as np
import torch

from genomics_lm_torch.training.runtime import PeriodicCheckpointPolicy, WallTimer

TRAINING_CONTRACT_VERSION = 1


@dataclass
class EngineState:
    completed_epochs: int = 0
    current_epoch: int = 0
    microbatch: int = 0
    optimizer_step: int = 0

    def to_dict(self) -> dict:
        return {
            "completed_epochs": self.completed_epochs,
            "current_epoch": self.current_epoch,
            "microbatch": self.microbatch,
            "optimizer_step": self.optimizer_step,
        }

    @classmethod
    def from_dict(cls, payload: dict) -> "EngineState":
        return cls(**{k: int(payload.get(k, 0)) for k in (
            "completed_epochs", "current_epoch", "microbatch", "optimizer_step",
        )})


@dataclass
class TrainingCheckpoint:
    """Versioned namespaced checkpoint envelope."""

    engine: dict
    task: Any
    strategy: Any
    rng: Any = None
    metadata: dict = field(default_factory=dict)
    version: int = TRAINING_CONTRACT_VERSION

    def to_payload(self) -> dict:
        return {
            "contract_version": self.version,
            "engine": self.engine,
            "task": self.task,
            "strategy": self.strategy,
            "rng": self.rng,
            "metadata": self.metadata,
            "run_progress": {
                "completed_epochs": self.engine.get("completed_epochs", 0),
                "current_epoch": self.engine.get("current_epoch", 0),
                "microbatch": self.engine.get("microbatch", 0),
                "optimizer_step": self.engine.get("optimizer_step", 0),
            },
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "TrainingCheckpoint":
        version = int(payload.get("contract_version", -1))
        if version != TRAINING_CONTRACT_VERSION:
            raise ValueError(
                f"unsupported training checkpoint contract version {version}; "
                f"expected {TRAINING_CONTRACT_VERSION}"
            )
        return cls(
            engine=dict(payload["engine"]),
            task=payload.get("task"),
            strategy=payload.get("strategy"),
            rng=payload.get("rng"),
            metadata=dict(payload.get("metadata", {})),
        )


@dataclass
class StepOutput:
    loss: float
    grads: Any
    metrics: dict = field(default_factory=dict)


@dataclass
class MetricValue:
    """Weighted metric for correct cross-batch averaging."""

    value: float
    weight: float = 1.0


@runtime_checkable
class TrainingTask(Protocol):
    def train_batches(self, epoch: int) -> Iterable[Any]: ...

    def training_step(self, batch) -> StepOutput: ...

    def val_batches(self) -> Iterable[Any]: ...

    def validation_step(self, batch) -> dict: ...

    def state_dict(self) -> Any: ...

    def load_state_dict(self, state) -> None: ...


@runtime_checkable
class UpdateStrategy(Protocol):
    def begin_group(self) -> None: ...

    def process_microbatch(self, task: TrainingTask, batch) -> StepOutput: ...

    def commit_group(self, task: TrainingTask) -> bool: ...

    def abort_group(self) -> int: ...

    def state_dict(self) -> Any: ...

    def load_state_dict(self, state) -> None: ...


@runtime_checkable
class TrainingCallback(Protocol):
    def on_event(self, name: str, payload: dict) -> None: ...


class NonFiniteStepError(RuntimeError):
    """Raised by strategies when a microbatch produces a nonfinite loss."""


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


class AccumulatedGradsStrategy:
    """Gradient accumulation with actual-size averaging and finite gating.

    The task computes the gradients; this strategy sums them over the
    group into its own tensors, averages by the number of processed
    microbatches, checks finiteness, clips, and applies them through the
    task's ``apply_updates``.
    """

    def __init__(self, apply_updates, *, grad_clip: float | None = None):
        self._apply_updates = apply_updates
        self.grad_clip = grad_clip
        self._grads = None
        self._count = 0
        self.committed_steps = 0

    def begin_group(self) -> None:
        self._grads = None
        self._count = 0

    def process_microbatch(self, task: TrainingTask, batch) -> StepOutput:
        out = task.training_step(batch)
        if not np.isfinite(out.loss):
            raise NonFiniteStepError(f"nonfinite loss {out.loss}")
        if self._grads is None:
            self._grads = _tree_map(lambda g: torch.as_tensor(g).detach().clone(), out.grads)
        else:
            _tree_map(lambda acc, g: acc.add_(g), self._grads, out.grads)
        self._count += 1
        return out

    def commit_group(self, task: TrainingTask) -> bool:
        if self._count == 0:
            return False
        grads = _tree_map(lambda g: g / self._count, self._grads)
        leaves = _leaves(grads)
        finite = bool(torch.stack([torch.isfinite(g).all().to(leaves[0].device)
                                   for g in leaves]).all())
        if not finite:
            self.abort_group()
            return False
        if self.grad_clip is not None:
            norm = torch.stack([g.float().pow(2).sum().to(leaves[0].device)
                                for g in leaves]).sum().sqrt()
            scale = torch.clamp(self.grad_clip / torch.clamp_min(norm, 1e-12), max=1.0)
            grads = _tree_map(lambda g: g * scale.to(g.device, g.dtype), grads)
        self._apply_updates(grads)
        self.committed_steps += 1
        self.begin_group()
        return True

    def abort_group(self) -> int:
        discarded = self._count
        self.begin_group()
        return discarded

    def state_dict(self) -> dict:
        return {"committed_steps": self.committed_steps}

    def load_state_dict(self, state) -> None:
        self.committed_steps = int((state or {}).get("committed_steps", 0))


class TrainingEngine:
    """Epoch/group loop over a protocol-typed task and strategy."""

    def __init__(
        self,
        task: TrainingTask,
        strategy: UpdateStrategy,
        *,
        group_size: int = 1,
        max_epochs: int = 1,
        wall_timer: WallTimer | None = None,
        checkpoint_policy: PeriodicCheckpointPolicy | None = None,
        save_fn=None,
        callbacks: list[TrainingCallback] | None = None,
        max_aborted_groups: int = -1,
    ):
        self.task = task
        self.strategy = strategy
        self.group_size = max(1, int(group_size))
        self.max_epochs = int(max_epochs)
        self.wall_timer = wall_timer or WallTimer(None)
        self.checkpoint_policy = checkpoint_policy
        self.save_fn = save_fn
        self.callbacks = list(callbacks or [])
        self.max_aborted_groups = max_aborted_groups
        self.state = EngineState()
        self.aborted_groups = 0
        self.history: list[dict] = []

    def _emit(self, name: str, payload: dict) -> None:
        for callback in self.callbacks:
            callback.on_event(name, payload)

    def _save(self, reason: str) -> None:
        if self.save_fn is None:
            return
        checkpoint = TrainingCheckpoint(
            engine=self.state.to_dict(),
            task=self.task.state_dict(),
            strategy=self.strategy.state_dict(),
            metadata={"reason": reason},
        )
        self.save_fn(checkpoint.to_payload())
        self._emit("checkpoint_saved", {"reason": reason})

    def restore(self, payload: dict) -> None:
        checkpoint = TrainingCheckpoint.from_payload(payload)
        self.state = EngineState.from_dict(checkpoint.engine)
        self.task.load_state_dict(checkpoint.task)
        self.strategy.load_state_dict(checkpoint.strategy)

    def _validate(self) -> dict:
        sums: dict[str, float] = {}
        weights: dict[str, float] = {}
        for batch in self.task.val_batches():
            metrics = self.task.validation_step(batch)
            for key, metric in metrics.items():
                if isinstance(metric, MetricValue):
                    value, weight = metric.value, metric.weight
                else:
                    value, weight = float(metric), 1.0
                sums[key] = sums.get(key, 0.0) + value * weight
                weights[key] = weights.get(key, 0.0) + weight
        return {k: sums[k] / max(weights[k], 1e-12) for k in sums}

    def _commit(self, epoch: int) -> bool:
        if not self.strategy.commit_group(self.task):
            return False
        self.state.optimizer_step += 1
        self._emit("group_committed", {
            "epoch": epoch + 1,
            "optimizer_step": self.state.optimizer_step,
        })
        return True

    def fit(self) -> list[dict]:
        stop = False
        for epoch in range(self.state.completed_epochs, self.max_epochs):
            self.state.current_epoch = epoch + 1
            skip = self.state.microbatch if epoch == self.state.completed_epochs else 0
            self.state.microbatch = 0
            self.strategy.begin_group()
            in_group = 0
            skip_to_group_end = False
            epoch_loss_sum, epoch_loss_n = 0.0, 0

            for index, batch in enumerate(self.task.train_batches(epoch + 1)):
                if index < skip:
                    continue
                self.state.microbatch = index + 1
                if not skip_to_group_end:
                    try:
                        out = self.strategy.process_microbatch(self.task, batch)
                        epoch_loss_sum += out.loss
                        epoch_loss_n += 1
                        in_group += 1
                    except NonFiniteStepError:
                        discarded = self.strategy.abort_group()
                        self.aborted_groups += 1
                        self._emit("group_aborted", {
                            "epoch": epoch + 1,
                            "microbatch": index + 1,
                            "discarded": discarded,
                        })
                        if (
                            self.max_aborted_groups >= 0
                            and self.aborted_groups > self.max_aborted_groups
                        ):
                            self._save("nonfinite_group_limit")
                            raise
                        skip_to_group_end = True
                if (index + 1) % self.group_size == 0:
                    if not skip_to_group_end and self._commit(epoch):
                        if self.checkpoint_policy and self.checkpoint_policy.should_save(
                            self.state.optimizer_step
                        ):
                            self._save("periodic")
                            self.checkpoint_policy.mark_saved(self.state.optimizer_step)
                    skip_to_group_end = False
                    in_group = 0
                    self.strategy.begin_group()
                if self.wall_timer.expired():
                    self._save("wall_time")
                    stop = True
                    break
            if not stop and in_group and not skip_to_group_end:
                self._commit(epoch)
            if stop:
                break

            val_metrics = self._validate()
            self._emit("validation_completed", {"epoch": epoch + 1, **val_metrics})
            self.state.completed_epochs = epoch + 1
            self.state.microbatch = 0
            record = {
                "epoch": epoch + 1,
                "train_loss": epoch_loss_sum / max(epoch_loss_n, 1),
                **val_metrics,
            }
            self.history.append(record)
            self._emit("epoch_completed", record)
            self._save("epoch")
        return self.history


__all__ = [
    "AccumulatedGradsStrategy",
    "EngineState",
    "MetricValue",
    "NonFiniteStepError",
    "StepOutput",
    "TrainingCallback",
    "TrainingCheckpoint",
    "TrainingEngine",
    "TrainingTask",
    "TRAINING_CONTRACT_VERSION",
    "UpdateStrategy",
]
