"""Checkpoint store (twin of ``genomics_lm_tpu/training/checkpoints.py``).

The same ``.npz`` container as the JAX package, so either package reads the
other's files: every array leaf of the payload tree is a ``ZIP_STORED``
``<tree path>.npy`` entry; the rest of the tree is one ``__meta__`` JSON
skeleton in which an array is ``{"__array__": path}`` and a tuple is
``{"__tuple__": [...]}``. A bfloat16 leaf is stored as its ``uint16`` bits
under ``"dtype": "bfloat16"``. Writes are atomic (temp file +
``os.replace``) and ``load_checkpoint_meta`` reads the skeleton alone.

What differs is the array type. A leaf may be a numpy array or a torch
tensor (moved to the host); reading gives numpy arrays, except a bfloat16
leaf, which becomes a ``torch.bfloat16`` tensor with the same bits (numpy
has no bfloat16, and the JAX reader's ``jnp.bfloat16`` is not available
here). A model is stored in the JAX tree layout
(``utils/weights.py::params_to_jax``), so the JAX package can load it.

Under data and tensor parallelism a checkpoint still holds full arrays, in
the one-process layout, so it resumes at any world size or tensor-parallel
degree: ``gather_to_writer`` brings every rank's host copies (its slices
of the split parameters, the moments it owns) to rank 0 in rank order,
which assembles them and alone writes the file (``training/loop.py``).

``transfer_load_params`` is the JAX function over numpy trees (token-aware
vocabulary-row remap with the same ``loaded/adapted/skipped/missing``
report). The width/depth expansion of ``training/expansion.py`` is the
port's own module of that name.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from genomics_lm_torch.training.runtime import atomic_write

_ARRAY_TAG = "__array__"
_TUPLE_TAG = "__tuple__"
_META_ENTRY = "__meta__"
_BFLOAT16_TAG = "bfloat16"


def _host_materialize(x, copy: bool = False):
    """A leaf as a host array: a tensor is detached and moved to the host
    (a bfloat16 tensor stays a tensor, since numpy has no bfloat16).
    ``copy`` copies a leaf that already lies on the host too, so the result
    shares no memory with ``x``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=copy)
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.array(x, copy=True) if copy else np.asarray(x)


def _flatten(obj: Any, path: str, arrays: dict[str, np.ndarray]):
    """Split payload into (JSON-able skeleton, path→array dict)."""
    if isinstance(obj, dict):
        return {str(k): _flatten(v, f"{path}/{k}", arrays) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE_TAG: [_flatten(v, f"{path}/{i}", arrays) for i, v in enumerate(obj)]}
    if isinstance(obj, list):
        return [_flatten(v, f"{path}/{i}", arrays) for i, v in enumerate(obj)]
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        arr = _host_materialize(obj)
        key = path.lstrip("/")
        if isinstance(arr, torch.Tensor):  # bfloat16: its bits as uint16
            arrays[key] = arr.contiguous().view(torch.int16).numpy().view(np.uint16)
            return {_ARRAY_TAG: key, "dtype": _BFLOAT16_TAG}
        if arr.dtype.name == _BFLOAT16_TAG:  # an ml_dtypes array from JAX
            arrays[key] = arr.view(np.uint16)
            return {_ARRAY_TAG: key, "dtype": _BFLOAT16_TAG}
        arrays[key] = arr
        return {_ARRAY_TAG: key}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"Unsupported checkpoint leaf at {path}: {type(obj)}")


def _unflatten(skel: Any, arrays) -> Any:
    if isinstance(skel, dict):
        if _ARRAY_TAG in skel:
            arr = arrays[skel[_ARRAY_TAG]]
            if skel.get("dtype") == _BFLOAT16_TAG and isinstance(arr, np.ndarray):
                bits = np.ascontiguousarray(arr).view(np.int16)
                return torch.from_numpy(bits).view(torch.bfloat16)
            return arr
        if _TUPLE_TAG in skel:
            return tuple(_unflatten(v, arrays) for v in skel[_TUPLE_TAG])
        return {k: _unflatten(v, arrays) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(v, arrays) for v in skel]
    return skel


def save_checkpoint(payload: dict[str, Any], path: str | Path) -> None:
    """Atomically write a payload tree to ``path`` (npz container)."""
    arrays: dict[str, np.ndarray] = {}
    skel = _flatten(payload, "", arrays)
    meta = json.dumps(skel, sort_keys=True).encode()

    def write(tmp: Path) -> None:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
            zf.writestr(_META_ENTRY, meta)
            for key, arr in arrays.items():  # streamed into its entry, not buffered
                with zf.open(key + ".npy", "w", force_zip64=arr.nbytes >= 2**31 - 2**20) as f:
                    np.save(f, arr, allow_pickle=False)

    atomic_write(path, write)


def link_checkpoint(src: str | Path, dst: str | Path) -> None:
    """Atomically make ``dst`` the checkpoint ``src`` holds, without writing
    it again: a hard link (``save_checkpoint`` replaces a path by a new file,
    so ``dst`` keeps these bytes), or a copy where the filesystem has none."""
    def write(tmp: Path) -> None:
        tmp.unlink(missing_ok=True)
        try:
            os.link(src, tmp)
        except OSError:
            shutil.copyfile(src, tmp)

    atomic_write(dst, write)


def _host_tree(tree):
    """The payload with every array leaf copied to the host: the caller goes
    on changing its tensors in place (the model, AdamW's moments and its
    CPU step counts) while the copy is written."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_host_tree(v) for v in tree]
        return tuple(seq) if isinstance(tree, tuple) else seq
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return _host_materialize(tree, copy=True)
    return tree


def gather_to_writer(obj):
    """``obj`` of every rank as a list in rank order on rank 0 (None on the
    other ranks); ``[obj]`` without a process group. Every rank must call it."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


class AsyncCheckpointer:
    """Background checkpoint writer: the copy of every array to the host
    happens on the caller thread (the tensors change with the next step,
    on the card and on the host alike), the
    serialization and the atomic file write on one worker thread. ``wait()``
    joins the in-flight write; a new ``save`` first joins the previous one so
    writes never reorder. Exceptions surface on the next ``save``/``wait``.
    """

    def __init__(self):
        import concurrent.futures

        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer"
        )
        self._pending = None

    def save(self, payload: dict[str, Any], path: str | Path) -> None:
        self.wait()
        self._pending = self._pool.submit(save_checkpoint, _host_tree(payload), path)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()  # re-raises writer exceptions

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_checkpoint(path: str | Path, keys: tuple[str, ...] | None = None) -> dict[str, Any]:
    """Load the payload tree (numpy arrays; bfloat16 leaves as tensors): the
    whole of it, or with ``keys`` only those top-level entries (the others'
    arrays, such as the optimizer state, are not read)."""
    with zipfile.ZipFile(path, "r") as zf:
        skel = json.loads(zf.read(_META_ENTRY).decode())
        if keys is not None:
            skel = {k: v for k, v in skel.items() if k in keys}
        arrays = {}
        for name in zf.namelist():
            if name == _META_ENTRY or (keys is not None and name.split("/", 1)[0] not in keys):
                continue
            arrays[name[: -len(".npy")]] = np.load(
                io.BytesIO(zf.read(name)), allow_pickle=False
            )
    return _unflatten(skel, arrays)


def load_checkpoint_meta(path: str | Path) -> dict[str, Any]:
    """Load only the JSON skeleton — arrays replaced by shape-free tags.

    Used by run-lifecycle progress/fingerprint validation so opening a run
    never reads the weights.
    """

    class _Missing:
        def __getitem__(self, key):
            return {"__array_ref__": key}

    with zipfile.ZipFile(path, "r") as zf:
        skel = json.loads(zf.read(_META_ENTRY).decode())
    return _unflatten(skel, _Missing())


def checkpoint_array(path: str | Path, key: str) -> np.ndarray:
    """Load a single array entry by tree path (e.g. 'model/tok_emb')."""
    with zipfile.ZipFile(path, "r") as zf:
        return np.load(io.BytesIO(zf.read(key + ".npy")), allow_pickle=False)


# --- Transfer loading with token-level vocabulary remap ----------------------


def transfer_load_params(
    target_params: dict,
    source_params: dict,
    *,
    source_itos: list[str] | None = None,
    target_itos: list[str] | None = None,
    vocab_axis_size: int | None = None,
) -> tuple[dict, dict]:
    """Initialize ``target_params`` from a source tree, remapping vocab rows.

    Both trees are numpy trees in the JAX layout (``params_to_jax``).
    Exact-shape leaves copy directly; leaves whose leading axis equals the
    vocabulary size copy row-wise through the token remap built from the two
    itos lists (unknown target tokens keep their fresh init). Returns
    (params, report) with loaded/adapted/skipped/missing path lists, as the
    JAX function does.
    """
    remap = None
    if source_itos is not None and target_itos is not None:
        src_index = {tok: i for i, tok in enumerate(source_itos)}
        remap = [(t, src_index[tok]) for t, tok in enumerate(target_itos) if tok in src_index]

    report = {"loaded": [], "adapted": [], "skipped": [], "missing": []}

    flat_src = _flatten_paths(source_params)
    flat_tgt = _flatten_paths(target_params)
    out = dict(flat_tgt)
    for path, tgt in flat_tgt.items():
        if path not in flat_src:
            report["missing"].append(path)
            continue
        src = _host_float(flat_src[path])
        tgt_np = _host_float(tgt)
        if src.shape == tgt_np.shape:
            out[path] = src.astype(tgt_np.dtype)
            report["loaded"].append(path)
        elif (
            remap is not None
            and vocab_axis_size is not None
            and src.ndim == tgt_np.ndim
            and src.shape[0] == len(remap and source_itos or [])
            and tgt_np.shape[0] == len(target_itos or [])
            and src.shape[1:] == tgt_np.shape[1:]
        ):
            merged = tgt_np.copy()
            for t_row, s_row in remap:
                merged[t_row] = src[s_row]
            out[path] = merged.astype(tgt_np.dtype)
            report["adapted"].append(path)
        else:
            report["skipped"].append(path)

    for path in flat_src:
        if path not in flat_tgt:
            report["skipped"].append(f"(source-only) {path}")

    return _unflatten_paths(out, target_params), report


def _host_float(x) -> np.ndarray:
    """A leaf as a numpy array (a bfloat16 tensor widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _flatten_paths(tree, prefix="") -> dict[str, Any]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten_paths(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten_paths(v, f"{prefix}/{i}"))
    else:
        flat[prefix.lstrip("/")] = tree
    return flat


def _unflatten_paths(flat: dict[str, Any], like: dict) -> dict:
    def rebuild(node, prefix=""):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            seq = [rebuild(v, f"{prefix}/{i}") for i, v in enumerate(node)]
            return tuple(seq) if isinstance(node, tuple) else seq
        return flat[prefix.lstrip("/")]

    return rebuild(like)


__all__ = [
    "AsyncCheckpointer",
    "checkpoint_array",
    "gather_to_writer",
    "link_checkpoint",
    "load_checkpoint",
    "load_checkpoint_meta",
    "save_checkpoint",
    "transfer_load_params",
]
