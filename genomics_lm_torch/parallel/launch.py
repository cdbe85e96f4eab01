"""Start N ranks of one function over a file store, and count collective time.

``spawn(fn, world, *args)`` runs ``fn(rank, world, *args)`` in ``world``
fresh interpreters (``python -m genomics_lm_torch.parallel.launch``, as a
launcher such as ``torchrun`` starts ranks: a child imports ``fn``'s
module and nothing of the caller's), each joined to the default process
group through a ``file://`` store in a fresh temporary directory, so
concurrent launches never share a port. Every rank runs on ``device``
(several ranks sharing one card go over gloo; see
``mesh.initialize_distributed``): by default the current CUDA card, and
without one ``spawn`` raises (``utils/device.py::resolve_device``); on the
CPU only when the caller passes ``device="cpu"``. The results come back in
rank order. A rank that fails, or a launch that outlives ``deadline_s``,
ends every rank and raises; a collective that waits longer than
``timeout_s`` fails its rank. The caller builds any kernels before it
spawns, so that no two ranks compile into ``kernels/_build/`` at once.

``timed`` wraps every collective the parallel layer issues. It counts the
calls and the bytes each one outputs on this rank, by operation (JAX's HLO
names: ``all-reduce``, ``all-gather``, ``reduce-scatter``, ``broadcast``,
``collective-permute`` for a send to a neighbour), and, when
``COLLECTIVES["timing"]`` is on, the wall time spent inside them (a CUDA
device is synchronized around each one, so the preceding work is not
counted): the share of a step that communication takes.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

COLLECTIVES = {"timing": False, "seconds": 0.0, "calls": 0, "bytes_by_op": {},
               "count_by_op": {}, "seconds_by_op": {}}


@contextlib.contextmanager
def timed(device=None, nbytes: int = 0, op: str = "all-reduce"):
    """Count the enclosed collective (``op``, ``nbytes`` output bytes on
    this rank), and its wall time while timing is on."""
    COLLECTIVES["calls"] += 1
    for key, add in (("bytes_by_op", int(nbytes)), ("count_by_op", 1)):
        COLLECTIVES[key][op] = COLLECTIVES[key].get(op, 0) + add
    if not COLLECTIVES["timing"]:
        yield
        return
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        COLLECTIVES["seconds"] += dt
        COLLECTIVES["seconds_by_op"][op] = COLLECTIVES["seconds_by_op"].get(op, 0.0) + dt


def reset_collective_timing(on: bool) -> None:
    COLLECTIVES.update(timing=bool(on), seconds=0.0, calls=0, bytes_by_op={},
                       count_by_op={}, seconds_by_op={})


def _rank_main(call_dir: str, rank: int) -> None:
    """One rank: the call's function on this rank, its result pickled."""
    import importlib

    import torch.distributed as dist

    from genomics_lm_torch.parallel.mesh import initialize_distributed

    with open(Path(call_dir) / "call.pkl", "rb") as f:
        module, name, world, device, backend, timeout_s, args = pickle.load(f)
    fn = getattr(importlib.import_module(module), name)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    initialize_distributed(f"file://{call_dir}/store", strict=True, device=device,
                           backend=backend, world_size=world, rank=rank, timeout_s=timeout_s)
    try:
        result = fn(rank, world, *args)
        with open(Path(call_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device: str | None = None, backend: str | None = None,
          timeout_s: float = 300.0, deadline_s: float = 1800.0) -> list:
    """``[fn(r, world, *args) for r in ranks]``, each in its own process."""
    from genomics_lm_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    tmp = tempfile.mkdtemp(prefix="ranks-")
    procs = []
    try:
        with open(Path(tmp) / "call.pkl", "wb") as f:
            pickle.dump((fn.__module__, fn.__qualname__, world, device, backend, timeout_s,
                         args), f)
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        procs = [subprocess.Popen([sys.executable, "-m", "genomics_lm_torch.parallel.launch",
                                   tmp, str(r)], env=env) for r in range(world)]
        end = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed or time.monotonic() > end:
                raise RuntimeError(f"a rank of {fn.__qualname__} failed (exit codes "
                                   f"{[p.returncode for p in procs]}) or the launch "
                                   f"outlived {deadline_s} s")
            time.sleep(0.05)
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"a rank of {fn.__qualname__} failed: exit codes {codes}")
        out = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


__all__ = ["COLLECTIVES", "reset_collective_timing", "spawn", "timed"]


if __name__ == "__main__":
    # the package's module, not this __main__ copy, so that the ranks' code
    # and the collectives share one COLLECTIVES
    from genomics_lm_torch.parallel import launch

    launch._rank_main(sys.argv[1], int(sys.argv[2]))
