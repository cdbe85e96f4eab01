"""Run lifecycle: directory ownership, locking, resume validation, RNG state.

Twin of ``genomics_lm_tpu/training/lifecycle.py``, copied verbatim apart
from the RNG snapshot: where JAX keeps the trainer's explicit key, the
port keeps the state of the trainer's ``torch.Generator`` (a CPU one, or
the card's when training runs there) and of torch's default CPU generator.

Layer L1 of the framework (behavioral spec: reference
``src/training/run_lifecycle.py``). A training run owns
``runs/<RUN_ID>/{checkpoints,scores,logs}`` plus ``run_complete.json`` and an
exclusive non-blocking ``flock`` on ``.run.lock``. Fresh launches allocate
serial directories (``run_id``, ``run_id-r002``, …) via atomic ``mkdir``;
resumes are fail-closed — only the newest ``last.npz`` may continue a run,
the immutable-config fingerprint must match, the curve history may not
run ahead of the checkpoint, and a completed run can only be extended with a
larger epoch target (its completion marker is archived).

RNG capture covers the host PRNGs (python, numpy, torch's default CPU
generator) plus the trainer's generator, which draws every dropout mask:
restoring it makes a resumed run draw the masks the straight run draws.

Several processes (data and tensor parallelism): ``open_run`` opens the
run on rank 0 alone, which owns the directory, its lock and every file it
writes; the other ranks get a ``FollowerRun`` with the same paths, or rank
0's error. ``stop_consensus`` is the per-group agreement on the periodic,
wall-time and signal triggers: a SIGTERM that lands on one rank stops every
rank at the same group boundary, where the one preemption checkpoint is
written.
"""

from __future__ import annotations

import atexit
import csv
import fcntl
import hashlib
import json
import os
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from genomics_lm_torch.training.checkpoints import load_checkpoint_meta

LAST_CHECKPOINT_NAME = "last.npz"
MAX_SERIAL_DIRS = 10000

# keys a resume may legitimately change without forking the run
DEFAULT_MUTABLE_CONFIG_KEYS = {
    "checkpoint_every_minutes",
    "checkpoint_every_steps",
    "epochs",
    "log_every_steps",
    "max_time_minutes",
    "run_id",
}


class RunLifecycleError(RuntimeError):
    """Raised when a launch would corrupt or ambiguously extend a run."""


@dataclass(frozen=True)
class RunProgress:
    completed_epochs: int
    current_epoch: int
    microbatch: int
    optimizer_step: int


# --- configuration identity --------------------------------------------------


def configuration_fingerprint(
    config: dict[str, Any], mutable_keys: set[str] | None = None
) -> str:
    """sha256 over the config with run-extendable keys pruned at any depth."""
    pruned = frozenset(
        DEFAULT_MUTABLE_CONFIG_KEYS if mutable_keys is None else mutable_keys
    )

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if k not in pruned}
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node

    canonical = json.dumps(
        strip(config), sort_keys=True, separators=(",", ":"), default=str
    )
    return hashlib.sha256(canonical.encode()).hexdigest()


def checkpoint_progress(payload: dict[str, Any]) -> RunProgress:
    raw = payload.get("run_progress")
    if not isinstance(raw, dict):
        raise RunLifecycleError(
            "Checkpoint has no unambiguous run_progress metadata. Legacy "
            "checkpoints must be migrated explicitly before in-place resume."
        )
    fields = ("completed_epochs", "current_epoch", "microbatch", "optimizer_step")
    return RunProgress(**{f: int(raw.get(f, 0)) for f in fields})


# --- RNG state ---------------------------------------------------------------


def capture_rng_state(generator: torch.Generator | None = None) -> dict[str, Any]:
    """Snapshot host RNGs (+ the trainer's generator, if given)."""
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    snapshot: dict[str, Any] = {
        "python": json.dumps(random.getstate()),
        "numpy": {
            "bit_generator": kind,
            "state": np.asarray(keys, dtype=np.uint32),
            "position": int(pos),
            "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached),
        },
        "torch_cpu": torch.get_rng_state().numpy().copy(),
    }
    if generator is not None:
        snapshot["torch_generator"] = {
            "device": generator.device.type,
            "state": generator.get_state().numpy().copy(),
        }
    return snapshot


def _as_nested_tuple(node):
    return tuple(_as_nested_tuple(v) for v in node) if isinstance(node, list) else node


def restore_rng_state(state: dict[str, Any] | None,
                      generator: torch.Generator | None = None) -> bool:
    """Restore host RNGs, and ``generator`` from the snapshot's trainer
    generator; True when the generator was restored. A snapshot taken on
    another device type (a CPU generator for a run now on the card) raises:
    the dropout masks would not continue the run's stream."""
    if not state:
        return False
    if "python" in state:
        random.setstate(_as_nested_tuple(json.loads(state["python"])))
    if "numpy" in state:
        packed = state["numpy"]
        np.random.set_state((
            str(packed["bit_generator"]),
            np.asarray(packed["state"], dtype=np.uint32),
            int(packed["position"]),
            int(packed["has_gauss"]),
            float(packed["cached_gaussian"]),
        ))
    if "torch_cpu" in state:
        torch.set_rng_state(torch.from_numpy(np.asarray(state["torch_cpu"], dtype=np.uint8)))
    saved = state.get("torch_generator")
    if generator is None or not saved:
        return False
    if saved["device"] != generator.device.type:
        raise RunLifecycleError(
            f"the checkpoint's generator state is for a {saved['device']} generator, "
            f"but the run trains on {generator.device.type}; resume on the same "
            "device type")
    generator.set_state(torch.from_numpy(np.asarray(saved["state"], dtype=np.uint8)))
    return True


# --- resume validators -------------------------------------------------------


def _run_dir_of(checkpoint: Path) -> Path:
    parent = checkpoint.parent
    return parent.parent if parent.name == "checkpoints" else parent


def _require_newest_checkpoint(run_dir: Path, checkpoint: Path, run_id: str,
                               last_name: str) -> None:
    newest = run_dir / "checkpoints" / last_name
    if not newest.is_file() or checkpoint != newest.resolve():
        raise RunLifecycleError(
            f"Cannot resume run '{run_id}' from {checkpoint.name}. Use the "
            f"newest {last_name} or provide a new run ID to fork."
        )


def _require_fingerprint_match(payload: dict, expected: str | None) -> None:
    recorded = payload.get("run_fingerprint")
    if expected is not None and recorded is not None and expected != recorded:
        raise RunLifecycleError(
            "Resume configuration changes immutable run settings. Use the "
            "checkpoint's configuration or a new run ID to fork."
        )


def validate_curve_history(path: Path, completed_epochs: int) -> None:
    """Curves must be strictly increasing and not run ahead of the checkpoint."""
    if not path.exists():
        return
    with path.open(newline="") as handle:
        body = [row for row in csv.reader(handle)][1:]
    recorded: list[int] = []
    for row in body:
        if row:
            try:
                recorded.append(int(row[0]))
            except ValueError as exc:
                raise RunLifecycleError(
                    f"Invalid epoch value in curve history: {row[0]!r}"
                ) from exc
    if recorded != sorted(set(recorded)):
        raise RunLifecycleError(
            f"Curve history contains duplicate or decreasing epochs: {path}"
        )
    if recorded and recorded[-1] > completed_epochs:
        raise RunLifecycleError(
            f"Curve history reaches epoch {recorded[-1]}, but the selected last "
            f"checkpoint has only {completed_epochs} completed epochs. Use a "
            "new run ID or repair the run explicitly."
        )


def _require_epoch_headroom(progress: RunProgress, target_epochs: int | None,
                            completion_marker: Path, run_id: str) -> None:
    if target_epochs is not None and int(target_epochs) <= progress.completed_epochs:
        raise RunLifecycleError(
            f"Run has {progress.completed_epochs} completed epochs, but target "
            f"epochs is {target_epochs}. Set epochs greater than "
            f"{progress.completed_epochs} or use a new run ID."
        )
    if completion_marker.exists() and target_epochs is None:
        raise RunLifecycleError(
            f"Run '{run_id}' is complete. Specify a greater total epoch target "
            "or use a new run ID."
        )


# --- the run directory -------------------------------------------------------


class TrainingRun:
    """Exclusive ownership of one training directory for one process."""

    SUBDIRS = ("checkpoints", "scores", "logs")

    def __init__(self, run_dir: Path, resume_checkpoint: Path | None) -> None:
        self.run_dir = run_dir
        self.resume_checkpoint = resume_checkpoint
        self.checkpoints, self.scores, self.logs = (
            run_dir / name for name in self.SUBDIRS
        )
        self.completion_path = run_dir / "run_complete.json"
        self.lock_path = run_dir / ".run.lock"
        self._lock_fd: int | None = None
        for sub in (self.checkpoints, self.scores, self.logs):
            sub.mkdir(parents=True, exist_ok=True)
        self._take_lock()
        atexit.register(self.close)

    # -- construction ---------------------------------------------------

    @classmethod
    def open(
        cls,
        root: str | Path,
        run_id: str,
        *,
        resume: str | Path | None = None,
        last_checkpoint_name: str = LAST_CHECKPOINT_NAME,
        target_epochs: int | None = None,
        curve_filename: str = "curves.csv",
        config_fingerprint: str | None = None,
    ) -> "TrainingRun":
        if resume is None:
            return cls(cls._allocate_serial(Path(root), run_id), None)

        checkpoint = Path(resume).expanduser().resolve()
        if not checkpoint.is_file():
            raise FileNotFoundError(f"Resume checkpoint not found: {checkpoint}")
        run_dir = _run_dir_of(checkpoint)
        if run_dir.name != run_id:
            raise RunLifecycleError(
                f"Resume checkpoint belongs to run '{run_dir.name}', but run ID "
                f"'{run_id}' was requested. Omit the override for in-place resume "
                "or use an explicit new run ID to fork."
            )
        _require_newest_checkpoint(run_dir, checkpoint, run_id, last_checkpoint_name)
        payload = load_checkpoint_meta(checkpoint)
        progress = checkpoint_progress(payload)
        _require_fingerprint_match(payload, config_fingerprint)
        validate_curve_history(
            run_dir / "scores" / curve_filename, progress.completed_epochs
        )
        completion_marker = run_dir / "run_complete.json"
        _require_epoch_headroom(progress, target_epochs, completion_marker, run_id)

        run = cls(run_dir, checkpoint)
        if completion_marker.exists():
            # extension of a finished run: archive its completion record
            os.replace(
                completion_marker,
                run_dir / f"run_complete_epoch_{progress.completed_epochs:03d}.json",
            )
        return run

    @staticmethod
    def _allocate_serial(root: Path, run_id: str) -> Path:
        """First free ``run_id``/``run_id-rNNN`` dir; mkdir is the atomicity."""
        root.mkdir(parents=True, exist_ok=True)
        for n in range(1, MAX_SERIAL_DIRS):
            candidate = root / (run_id if n == 1 else f"{run_id}-r{n:03d}")
            try:
                candidate.mkdir(parents=True)
            except FileExistsError:
                continue
            return candidate
        raise RunLifecycleError(f"Could not allocate a serial directory for {run_id}")

    # -- locking --------------------------------------------------------

    def _take_lock(self) -> None:
        fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError as exc:
            os.close(fd)
            raise RunLifecycleError(
                f"Run directory is already locked: {self.run_dir}"
            ) from exc
        os.ftruncate(fd, 0)
        os.write(fd, f"pid={os.getpid()}\n".encode())
        self._lock_fd = fd

    def close(self) -> None:
        fd, self._lock_fd = self._lock_fd, None
        if fd is not None:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    # -- run products ---------------------------------------------------

    def mark_complete(self, metadata: dict[str, Any]) -> None:
        staging = self.completion_path.with_suffix(".json.tmp")
        staging.write_text(
            json.dumps({"status": "complete", **metadata}, indent=2, sort_keys=True)
            + "\n"
        )
        os.replace(staging, self.completion_path)

    def logger(self, filename: str = "train.log"):
        from genomics_lm_torch.training.runtime import RunLogger

        return RunLogger(self.logs / filename)

    # -- lifetime -------------------------------------------------------

    def __del__(self) -> None:
        self.close()

    def __enter__(self) -> "TrainingRun":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


class FollowerRun:
    """The run as a rank other than rank 0 sees it: rank 0's directory and
    resume checkpoint, and no lock, directory or file of its own."""

    def __init__(self, run_dir: str, resume_checkpoint: str | None) -> None:
        self.run_dir = Path(run_dir)
        self.resume_checkpoint = Path(resume_checkpoint) if resume_checkpoint else None
        self.checkpoints, self.scores, self.logs = (
            self.run_dir / name for name in TrainingRun.SUBDIRS)

    def close(self) -> None:
        pass

    def mark_complete(self, metadata: dict[str, Any]) -> None:
        pass


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def open_run(root: str | Path, run_id: str, **kwargs):
    """``TrainingRun.open`` on rank 0; the other ranks of the world get a
    ``FollowerRun`` of the same directory, or raise rank 0's error. One
    process: ``TrainingRun.open`` itself."""
    rank, size = _world()
    if size == 1:
        return TrainingRun.open(root, run_id, **kwargs)
    import torch.distributed as dist

    run, error, shared = None, None, [None]
    if rank == 0:
        try:
            run = TrainingRun.open(root, run_id, **kwargs)
            resume = run.resume_checkpoint
            shared = [("ok", str(run.run_dir), str(resume) if resume else None)]
        except Exception as exc:  # every rank must leave the collective below
            error = exc
            shared = [("error", type(exc).__name__, str(exc))]
    dist.broadcast_object_list(shared, src=0)
    status, first, second = shared[0]
    if error is not None:
        raise error
    if status == "error":
        raise RunLifecycleError(f"rank 0 could not open the run: {first}: {second}")
    return run if rank == 0 else FollowerRun(first, second)


def stop_consensus(periodic: bool, wall: bool, preempt: bool, device) -> tuple[bool, bool, bool]:
    """The periodic-save, wall-time and signal triggers agreed over every
    rank (the max of each), at every group boundary and unconditionally:
    a trigger seen on one rank (its clock, a SIGTERM sent to it alone) acts
    on all of them at the same group, or the ranks' collectives would part."""
    if _world()[1] == 1:
        return periodic, wall, preempt
    import torch.distributed as dist

    bits = torch.tensor([periodic, wall, preempt], dtype=torch.int32, device=device)
    dist.all_reduce(bits, op=dist.ReduceOp.MAX)
    return tuple(bool(b) for b in bits.tolist())


__all__ = [
    "DEFAULT_MUTABLE_CONFIG_KEYS",
    "FollowerRun",
    "LAST_CHECKPOINT_NAME",
    "RunLifecycleError",
    "RunProgress",
    "TrainingRun",
    "capture_rng_state",
    "checkpoint_progress",
    "configuration_fingerprint",
    "open_run",
    "restore_rng_state",
    "stop_consensus",
    "validate_curve_history",
]
