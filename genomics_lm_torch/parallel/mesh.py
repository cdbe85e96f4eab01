"""Process meshes (twin of ``genomics_lm_tpu/parallel/mesh.py``).

JAX lays a mesh over the devices of one program. PyTorch runs one process
per device, so here a mesh is laid over the ranks of the default process
group: ``make_mesh`` keeps JAX's axis arithmetic (row-major axes, at most
one ``-1`` wildcard, the same ``ValueError``s) and, when the mesh spans the
initialized world, creates one process group per line of each axis. A
rank's coordinate on an axis is its index in that axis's group.

``initialize_distributed`` is the bring-up. By default a rank that cannot
join warns loudly and returns False (JAX's contract); ``strict=True``
raises, and the port's own launch path (``training/train_codon_lm.py``)
calls it strictly. The rank's device follows one rule: ``cuda:{LOCAL_RANK}``
by default, raising if that card is absent; an explicit ``device`` puts
every rank on it (several ranks sharing one card). The backend follows the
device: NCCL when each rank has its own card (or the world is one rank),
gloo on the CPU or on a card that several ranks share, since NCCL refuses
two ranks on one device. The choice is printed on a ``[mesh]`` line.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

_STATE: dict = {"device": None, "backend": None}


def local_device_count() -> int:
    """Cards visible to this process (JAX: ``jax.local_device_count()``)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class Mesh:
    """Named axes over ranks: ``devices`` is the rank array of shape
    ``tuple(shape.values())``; ``groups[axis]`` is this rank's process
    group along ``axis`` (None when the mesh does not span an initialized
    world; a group of one rank for an axis of size 1); ``coords[axis]`` is
    this rank's index along it."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    groups: dict = field(default_factory=dict)
    coords: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_rank(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(n_devices: int | None = None, *, axes: dict[str, int] | None = None,
              devices=None) -> Mesh:
    """Build a Mesh. Default: 1-D ``('data',)`` over all ranks.

    ``axes`` maps axis name → size (row-major over the rank list); sizes
    must multiply to the rank count, with at most one -1 wildcard.
    ``devices`` (default: the ranks of the world) may name ranks directly.
    Every rank of the world must call this in the same order: the axis
    groups are made collectively.
    """
    rank, size = world()
    if devices is None:
        devices = list(range(size))
    if n_devices is not None:
        devices = devices[:n_devices]
    devices = np.asarray(devices)

    if axes is None:
        axes = {DATA_AXIS: len(devices)}
    names = tuple(axes.keys())
    sizes = list(axes.values())
    wildcards = [i for i, s in enumerate(sizes) if s == -1]
    if len(wildcards) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if wildcards:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if len(devices) % known:
            raise ValueError(f"{len(devices)} devices not divisible by {known}")
        sizes[wildcards[0]] = len(devices) // known
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} != {len(devices)} devices")
    mesh = Mesh(devices.reshape(sizes), names)

    spans_world = (dist.is_available() and dist.is_initialized()
                   and sorted(devices.tolist()) == list(range(size)))
    if not spans_world:
        return mesh
    where = np.argwhere(mesh.devices == rank)[0]
    for ax, name in enumerate(names):
        mesh.coords[name] = int(where[ax])
        # every line of the axis: the ranks that differ only in this coordinate
        lines = np.moveaxis(mesh.devices, ax, -1).reshape(-1, mesh.devices.shape[ax])
        for line in lines:
            members = [int(r) for r in line]
            group = dist.new_group(members)
            if rank in members:
                mesh.groups[name] = group
    return mesh


def initialize_distributed(
    init_method: str | None = None,
    *,
    strict: bool = False,
    device: str | torch.device | None = None,
    backend: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join the default process group (``torch.distributed.init_process_group``).

    ``init_method`` defaults to ``env://`` (``torchrun``'s ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); ``rank``/``world_size``
    default to the environment's. Returns True on success (also when the
    group already exists). A failure raises under ``strict``; otherwise it
    degrades to one process with a LOUD warning carrying the exception text
    and returns False. A collective that waits longer than ``timeout_s``
    fails instead of hanging.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    try:
        rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
        world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                      else int(world_size))
        dev = rank_device(device)
        if backend is None:
            own_card = device is None or world_size == 1
            backend = "nccl" if dev.type == "cuda" and own_card else "gloo"
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    except (RuntimeError, ValueError, OSError) as exc:
        if strict:
            raise RuntimeError(
                f"distributed bring-up failed (init_method={init_method!r}): {exc}"
            ) from exc
        msg = ("distributed bring-up FAILED — continuing as one process. "
               f"init_method={init_method!r} error: {exc}")
        logger.warning(msg)
        print(f"[mesh] WARNING: {msg}", file=sys.stderr, flush=True)
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _STATE.update(device=dev, backend=backend)
    print(f"[mesh] rank {rank}/{world_size} backend={backend} device={dev}", flush=True)
    return True


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: ``device`` when given (every rank on it), else
    ``cuda:{LOCAL_RANK}``, raising if that card is absent."""
    if device is not None:
        return torch.device(device)
    if _STATE["device"] is not None:
        return _STATE["device"]
    local = int(os.environ.get("LOCAL_RANK", 0))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank with LOCAL_RANK={local} has no card (cuda:{local}; "
            f"{local_device_count() if torch.cuda.is_available() else 0} visible); "
            "pass device='cpu' or a shared device to run every rank there")
    return torch.device("cuda", local)


def backend() -> str | None:
    """The default group's backend, or None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "PIPE_AXIS",
    "backend",
    "initialize_distributed",
    "local_device_count",
    "make_mesh",
    "rank_device",
    "world",
]
