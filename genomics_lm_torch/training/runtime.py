"""Run runtime: wall-clock budgets, checkpoint cadence, atomic IO, crash logs.

Twin of ``genomics_lm_tpu/training/runtime.py``, copied verbatim apart
from the device probes: ``device_memory_stats`` reads PyTorch's CUDA
allocator (``torch.cuda.max_memory_allocated``) and gives an empty dict on
the CPU, and JAX's ``default_device`` is left out (the port's entry points
take their device from ``utils/device.py::resolve_device``).

Layer L0 of the framework (behavioral spec: reference
``src/training/runtime.py``): a wall timer whose ``check()`` raises when the
run's time budget is spent, a periodic checkpoint policy driven by optimizer
steps and/or minutes, temp-file + ``os.replace`` atomic writes, and a run
logger that tees stdout/stderr into the run log while capturing crash
forensics (faulthandler, thread/unraisable hooks, SIGTERM/SIGINT/SIGHUP
stack dumps chaining to prior handlers with exit code 128+sig).

Structure: the forensic hooks live in their own ``_CrashForensics`` helper
that ``RunLogger`` composes; timers take an injectable clock for tests.
"""

from __future__ import annotations

import atexit
import faulthandler
import os
import signal
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable, TextIO

_HANDLED_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)


class WallTimeLimitException(Exception):
    """Raised when a trainer reaches its configured wall-time budget."""


class PreemptionRequested(WallTimeLimitException):
    """Raised at a microbatch boundary after a termination signal arrived.

    Subclasses ``WallTimeLimitException`` so it rides the trainer's existing
    graceful-stop path (save ``last``, flush metrics, status "stopped") —
    the checkpoint reason distinguishes ``preempted`` from ``wall_time``.
    """


class GracefulPreemption:
    """Deferred SIGTERM handling built on the checkpoint contract.

    The reference logs a stack and exits on SIGTERM
    (``src/training/runtime.py:209-242``), losing mid-epoch work. On
    preemptible TPU pods that is the difference between losing an epoch and
    losing nothing, so here the FIRST termination signal only sets a flag;
    the trainer polls :meth:`check` at microbatch boundaries, saves ``last``
    with ``checkpoint_reason: preempted``, writes meta, and exits cleanly.
    A SECOND signal falls through to the prior handler (hard exit 128+sig)
    so a stuck save cannot block termination.
    """

    def __init__(self, signals: tuple = (signal.SIGTERM,)) -> None:
        self._signals = signals
        self._prior: dict[int, Any] = {}
        self.requested = False
        self.signum: int | None = None

    def install(self) -> "GracefulPreemption":
        for sig in self._signals:
            try:
                self._prior[int(sig)] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                # non-main thread or unsupported platform: stay passive
                pass
        return self

    def uninstall(self) -> None:
        for signum, prior in self._prior.items():
            try:
                signal.signal(signum, prior)
            except Exception:
                pass
        self._prior.clear()

    def _on_signal(self, signum, frame) -> None:
        if self.requested:
            prior = self._prior.get(signum, signal.SIG_DFL)
            try:
                signal.signal(signum, prior)
            except Exception:
                pass
            if callable(prior):
                prior(signum, frame)
                return
            raise SystemExit(128 + signum)
        self.requested = True
        self.signum = int(signum)
        print(
            f"[signal] {signal.Signals(signum).name} received — saving a "
            "preemption checkpoint at the next microbatch boundary "
            "(send again to force exit)",
            flush=True,
        )

    def check(self) -> None:
        if self.requested:
            name = signal.Signals(self.signum).name if self.signum else "signal"
            raise PreemptionRequested(f"preempted by {name}")


def device_memory_stats(device=None) -> dict[str, int]:
    """Peak and current allocated bytes of a CUDA device (PyTorch's caching
    allocator); an empty dict on the CPU. With no device it reads the card,
    as JAX's twin reads the default accelerator, and raises without one.
    ``peak_bytes_in_use`` is the key the trainer reads, as it reads JAX's
    ``memory_stats()``."""
    import torch

    from genomics_lm_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    return {
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        "bytes_in_use": int(torch.cuda.memory_allocated(device)),
    }


class WallTimer:
    """Elapsed-time budget; ``check()`` raises once the budget is spent."""

    def __init__(
        self,
        max_minutes: float | None = None,
        *,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.max_minutes = max_minutes
        self._clock = clock
        self.started_at = clock()

    @property
    def max_seconds(self) -> float | None:
        return None if self.max_minutes is None else float(self.max_minutes) * 60.0

    def elapsed_seconds(self) -> float:
        return self._clock() - self.started_at

    def expired(self) -> bool:
        budget = self.max_seconds
        return budget is not None and self.elapsed_seconds() > budget

    def check(self) -> None:
        if self.expired():
            raise WallTimeLimitException()


class PeriodicCheckpointPolicy:
    """Save every N optimizer steps and/or every M wall-clock minutes.

    Either trigger fires a save; ``mark_saved`` resets both. A step at or
    below the last-saved step never triggers (duplicate-save guard).
    """

    def __init__(
        self,
        every_steps: int = 0,
        every_minutes: float = 0.0,
        last_saved_step: int = 0,
        *,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.every_steps = int(every_steps or 0)
        self.every_minutes = float(every_minutes or 0.0)
        self._clock = clock
        self.last_saved_step = int(last_saved_step or 0)
        self.last_saved_at = clock()

    def should_save(self, step: int) -> bool:
        if step <= self.last_saved_step:
            return False
        by_steps = self.every_steps > 0 and step % self.every_steps == 0
        by_time = (
            self.every_minutes > 0
            and self._clock() - self.last_saved_at >= self.every_minutes * 60.0
        )
        return by_steps or by_time

    def mark_saved(self, step: int) -> None:
        self.last_saved_step = int(step)
        self.last_saved_at = self._clock()


def atomic_write(path: str | Path, write_fn: Callable[[Path], None]) -> None:
    """Write through a same-directory temp file, then atomically replace.

    Same-directory matters: ``os.replace`` is only atomic within one
    filesystem, and a crash mid-write leaves the final path untouched.
    """
    target = Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    staging = target.with_name(f".{target.name}.tmp")
    write_fn(staging)
    os.replace(staging, target)


class _Tee:
    """Fan a text stream out to several underlying streams, flushing each."""

    def __init__(self, *streams: TextIO) -> None:
        self.streams = streams

    def write(self, data: str) -> int:
        for s in self.streams:
            s.write(data)
            s.flush()
        return len(data)

    def flush(self) -> None:
        for s in self.streams:
            s.flush()

    def isatty(self) -> bool:
        return any(getattr(s, "isatty", lambda: False)() for s in self.streams)


class _CrashForensics:
    """Installable crash hooks that dump tracebacks into the run log.

    Covers: hard faults (faulthandler), uncaught thread exceptions,
    unraisable exceptions, and termination signals. Signals log the live
    stack, detach everything, chain to the previous handler, and exit
    with the conventional 128+signum code.
    """

    def __init__(self, emit: Callable[[str], None], log_file: TextIO,
                 on_teardown: Callable[[], None]) -> None:
        self._emit = emit
        self._file = log_file
        self._on_teardown = on_teardown
        self._prior_thread_hook = None
        self._prior_unraisable_hook = None
        self._prior_signals: dict[int, Any] = {}

    def _dump(self, etype, evalue, etb) -> None:
        traceback.print_exception(etype, evalue, etb, file=self._file)
        self._file.flush()

    def install(self) -> None:
        try:
            faulthandler.enable(file=self._file, all_threads=True)
        except Exception:
            pass
        self._hook_threads()
        self._hook_unraisable()
        for sig in _HANDLED_SIGNALS:
            self._hook_signal(sig)

    def _hook_threads(self) -> None:
        self._prior_thread_hook = getattr(threading, "excepthook", None)
        if self._prior_thread_hook is None:
            return

        def on_thread_crash(args):
            self._emit("[error] unhandled thread exception:")
            self._dump(args.exc_type, args.exc_value, args.exc_traceback)
            self._prior_thread_hook(args)

        threading.excepthook = on_thread_crash

    def _hook_unraisable(self) -> None:
        self._prior_unraisable_hook = getattr(sys, "unraisablehook", None)
        if self._prior_unraisable_hook is None:
            return

        def on_unraisable(info):
            self._emit(f"[error] unraisable exception: {info.err_msg}")
            self._dump(info.exc_type, info.exc_value, info.exc_traceback)
            self._prior_unraisable_hook(info)

        sys.unraisablehook = on_unraisable

    def _hook_signal(self, sig: signal.Signals) -> None:
        try:
            self._prior_signals[int(sig)] = signal.getsignal(sig)

            def on_signal(signum, frame):
                self._emit(f"[signal] received {signal.Signals(signum).name}; exiting")
                if frame is not None:
                    traceback.print_stack(frame, file=self._file)
                    self._file.flush()
                chained = self._prior_signals.get(signum)
                self._on_teardown()
                if callable(chained):
                    chained(signum, frame)
                elif chained == signal.SIG_IGN:
                    return
                raise SystemExit(128 + signum)

            signal.signal(sig, on_signal)
        except Exception:
            pass

    def uninstall(self) -> None:
        for signum, prior in self._prior_signals.items():
            try:
                signal.signal(signum, prior)
            except Exception:
                pass
        self._prior_signals.clear()
        if self._prior_thread_hook is not None:
            threading.excepthook = self._prior_thread_hook
        if self._prior_unraisable_hook is not None:
            sys.unraisablehook = self._prior_unraisable_hook


class RunLogger:
    """Mirror stdout/stderr into a per-run log with crash forensics.

    Context manager: on unhandled exceptions the traceback lands in the log
    before an exit record (status + elapsed seconds) is appended.
    """

    def __init__(self, log_path: str | Path) -> None:
        self.log_path = Path(log_path)
        self._file: TextIO | None = None
        self._saved_streams: tuple[TextIO, TextIO] | None = None
        self._opened_at: float | None = None
        self._closed = False
        self._forensics: _CrashForensics | None = None
        self._atexit_registered = False

    # -- context manager ------------------------------------------------

    def __enter__(self) -> "RunLogger":
        self.log_path.parent.mkdir(parents=True, exist_ok=True)
        self._file = self.log_path.open("a", buffering=1)
        self._opened_at = time.perf_counter()
        self._saved_streams = (sys.stdout, sys.stderr)
        sys.stdout = _Tee(sys.stdout, self._file)  # type: ignore[assignment]
        sys.stderr = _Tee(sys.stderr, self._file)  # type: ignore[assignment]
        print(f"[log] writing run log to {self.log_path}")
        self._forensics = _CrashForensics(self._emit, self._file, self._teardown)
        self._forensics.install()
        if not self._atexit_registered:
            atexit.register(self._on_atexit)
            self._atexit_registered = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None and self._file is not None and not self._closed:
            self._file.write("\n[error] unhandled exception:\n")
            traceback.print_exception(exc_type, exc, tb, file=self._file)
            self._file.flush()
        status = "exit" if exc_type is None else "exception"
        if self._opened_at is None:
            self._emit(f"[log] run logger closing status={status}")
        else:
            elapsed = time.perf_counter() - self._opened_at
            self._emit(
                f"[log] run logger closing status={status} elapsed_sec={elapsed:.2f}"
            )
        self._teardown()
        return False

    # -- internals ------------------------------------------------------

    def _emit(self, line: str) -> None:
        if self._file is not None and not self._closed:
            self._file.write(line.rstrip("\n") + "\n")
            self._file.flush()

    def _teardown(self) -> None:
        if self._forensics is not None:
            self._forensics.uninstall()
            self._forensics = None
        if self._saved_streams is not None:
            sys.stdout, sys.stderr = self._saved_streams
            self._saved_streams = None
        if self._file is not None:
            self._file.close()
        self._closed = True

    def _on_atexit(self) -> None:
        if not self._closed:
            self._emit("[log] process atexit reached before logger close")


__all__ = [
    "GracefulPreemption",
    "PeriodicCheckpointPolicy",
    "PreemptionRequested",
    "RunLogger",
    "WallTimeLimitException",
    "WallTimer",
    "atomic_write",
    "device_memory_stats",
]
