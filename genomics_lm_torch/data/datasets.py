"""Packed datasets and host-side batching (twin of ``genomics_lm_tpu/data/datasets.py``).

``dataset_length_audit``, ``PackedDataset``, ``EpochPlan`` and
``grouped_batches`` are a verbatim numpy copy of the JAX module: the same
NPZ packs (``X``/``Y`` fixed, ``X`` + ``lengths`` dynamic), the same
``_X/_Y/_lengths.npy`` mmap sidecars, the same ``SeedSequence([seed,
epoch])`` order with host shards and length buckets, and the same (G, B, T)
accumulation groups with a ragged last group and a PAD-padded last
microbatch. ``tests/test_torch_data.py`` holds both copies to identical
batches.

``DevicePrefetcher`` is the port's own: a worker thread stages each group
from pinned host memory onto the device on a side CUDA stream, and the
consumer's stream waits for that copy before it uses the tensors.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

PAD_ID = 0


def dataset_length_audit(dataset, block_size: int) -> dict:
    """Length percentiles + at-block-size fraction (parity: data_loading.py:13-40)."""
    if len(dataset) == 0:
        return {
            "n_sequences": 0,
            "min": None,
            "p50": None,
            "p90": None,
            "p99": None,
            "max": None,
            "at_block_size": 0,
            "at_block_size_frac": 0.0,
            "mode": "dynamic" if dataset.is_dynamic else "fixed",
        }
    lengths = np.asarray(dataset.seq_lengths, dtype=np.int64)
    return {
        "n_sequences": int(len(lengths)),
        "min": int(lengths.min()),
        "p50": float(np.percentile(lengths, 50)),
        "p90": float(np.percentile(lengths, 90)),
        "p99": float(np.percentile(lengths, 99)),
        "max": int(lengths.max()),
        "at_block_size": int((lengths >= int(block_size)).sum()),
        "at_block_size_frac": float((lengths >= int(block_size)).mean()),
        "mode": "dynamic" if dataset.is_dynamic else "fixed",
    }


class PackedDataset:
    """Unified fixed/dynamic packed dataset over NPZ files or NPY sidecars.

    ``use_mmap=True`` prefers uncompressed ``<stem>_X.npy`` (+``_Y``/
    ``_lengths``) sidecars via ``np.load(mmap_mode='r')`` — the RSS −99.8%
    path of the reference benchmark (BASELINE.md) — falling back to
    in-memory NPZ.
    """

    def __init__(self, paths, *, use_mmap: bool = False):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.paths = [Path(p) for p in paths]
        if not self.paths:
            raise ValueError("PackedDataset needs at least one path")

        self.storage_mode = "npz_memory"
        sidecars = []
        if use_mmap:
            for p in self.paths:
                x_path = p.with_name(p.stem + "_X.npy")
                y_path = p.with_name(p.stem + "_Y.npy")
                len_path = p.with_name(p.stem + "_lengths.npy")
                if x_path.exists() and (len_path.exists() or y_path.exists()):
                    sidecars.append((x_path, y_path if y_path.exists() else None,
                                     len_path if len_path.exists() else None))
                else:
                    sidecars = []
                    break

        self._X: list[np.ndarray] = []
        self._Y: list[np.ndarray] = []
        self._lengths: list[np.ndarray] = []
        self._offsets: list[np.ndarray] = []

        if sidecars:
            kinds = {len_path is not None for _, _, len_path in sidecars}
            if len(kinds) != 1:
                raise ValueError("all mmap dataset shards must share one format")
            self.storage_mode = "npy_mmap"
            self.is_dynamic = sidecars[0][2] is not None
            for x_path, y_path, len_path in sidecars:
                X = np.load(x_path, mmap_mode="r")
                self._X.append(X)
                if self.is_dynamic:
                    lengths = np.asarray(np.load(len_path, mmap_mode="r"))
                    self._lengths.append(lengths)
                    self._offsets.append(np.concatenate([[0], np.cumsum(lengths[:-1])]))
                else:
                    self._Y.append(np.load(y_path, mmap_mode="r"))
        else:
            with np.load(self.paths[0], allow_pickle=False) as probe:
                self.is_dynamic = "lengths" in probe
            for p in self.paths:
                with np.load(p, allow_pickle=False) as data:
                    if self.is_dynamic:
                        lengths = np.asarray(data["lengths"])
                        self._X.append(np.asarray(data["X"]))
                        self._lengths.append(lengths)
                        self._offsets.append(np.concatenate([[0], np.cumsum(lengths[:-1])]))
                    else:
                        self._X.append(np.asarray(data["X"]))
                        self._Y.append(np.asarray(data["Y"]))

        if self.is_dynamic:
            counts = [len(l) for l in self._lengths]
        else:
            counts = [x.shape[0] for x in self._X]
        self._file_of = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
        self._local_of = np.concatenate(
            [np.arange(c, dtype=np.int32) for c in counts]
        ) if counts else np.zeros(0, np.int32)
        self._total = int(sum(counts))

    def __len__(self) -> int:
        return self._total

    @property
    def block_size(self) -> int | None:
        if self.is_dynamic:
            return None
        return int(self._X[0].shape[1]) if self._X else 0

    @property
    def seq_lengths(self) -> np.ndarray:
        """Per-window token counts (dynamic) or the fixed block size."""
        if self.is_dynamic:
            return np.concatenate(self._lengths).astype(np.int32, copy=False)
        return np.full(len(self), self.block_size, dtype=np.int32)

    def window_tokens(self, i: int) -> np.ndarray:
        """Raw token window i (dynamic mode only)."""
        if not self.is_dynamic:
            raise ValueError("window_tokens is only defined for dynamic datasets")
        fi, li = int(self._file_of[i]), int(self._local_of[i])
        start = int(self._offsets[fi][li])
        length = int(self._lengths[fi][li])
        return np.asarray(self._X[fi][start : start + length])

    def fetch_batch(
        self, indices, *, pad_to: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Gather a batch of (x, y) int32 arrays, padding to ``pad_to``.

        Fixed mode returns (B, block); dynamic mode shifts each window into
        (x, y) next-token pairs padded with PAD_ID, exactly the reference's
        ``dynamic_lm_collate_fn``/``fetch_batch`` semantics
        (data_loading.py:271-315) but with a caller-controlled padded width
        for shape-stable compilation.
        """
        indices = np.asarray(indices, dtype=np.int64)
        if indices.size == 0:
            width = pad_to or 0
            return (np.zeros((0, width), np.int32), np.zeros((0, width), np.int32))
        file_ids = self._file_of[indices]
        local_ids = self._local_of[indices]

        if not self.is_dynamic:
            width = self.block_size
            x = np.empty((len(indices), width), dtype=np.int32)
            y = np.empty((len(indices), width), dtype=np.int32)
            for fi in np.unique(file_ids):
                mask = file_ids == fi
                rows = local_ids[mask]
                x[mask] = self._X[int(fi)][rows]
                y[mask] = self._Y[int(fi)][rows]
            return x, y

        lengths = np.asarray(
            [int(self._lengths[int(fi)][int(li)]) for fi, li in zip(file_ids, local_ids)],
            dtype=np.int64,
        )
        width = int(pad_to) if pad_to is not None else max(0, int(lengths.max()) - 1)
        x = np.full((len(indices), width), PAD_ID, dtype=np.int32)
        y = np.full((len(indices), width), PAD_ID, dtype=np.int32)
        for row, (fi, li, length) in enumerate(zip(file_ids, local_ids, lengths)):
            start = int(self._offsets[int(fi)][int(li)])
            seq = self._X[int(fi)][start : start + int(length)]
            usable = min(max(0, int(length) - 1), width)
            if usable:
                x[row, :usable] = seq[:usable]
                y[row, :usable] = seq[1 : usable + 1]
        return x, y


def build_codon_lm_datasets(train_paths, val_paths, use_mmap: bool = False):
    return (
        PackedDataset(train_paths, use_mmap=use_mmap),
        PackedDataset(val_paths, use_mmap=use_mmap),
    )


def _bucket_edges_pow2(lengths: np.ndarray, block_size: int | None) -> list[int]:
    """Power-of-two padded widths covering the observed length range."""
    max_len = int(lengths.max())
    edges, width = [], 16
    while width < max_len - 1:
        edges.append(width)
        width *= 2
    edges.append(max(1, max_len - 1))
    return edges


def bucket_for_lengths(lengths: np.ndarray, edges: list[int]) -> np.ndarray:
    """Index of the smallest edge >= (length - 1) for each window."""
    widths = np.asarray(edges)
    usable = np.maximum(0, lengths - 1)
    return np.searchsorted(widths, usable, side="left").clip(0, len(edges) - 1)


class EpochPlan:
    """Deterministic (seed, epoch, host)-keyed batch plan for one epoch.

    Produces microbatch index lists; dynamic datasets are length-bucketed
    into a bounded set of padded widths (shape-stable under jit). The plan is
    identical on every host; each host then takes its interleaved shard of
    every microbatch's row indices, so the global batch is consistent.
    """

    def __init__(
        self,
        dataset: PackedDataset,
        *,
        batch_size: int,
        seed: int,
        epoch: int,
        shuffle: bool = True,
        bucket_batching: bool = False,
        n_buckets: int = 8,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & 0x7FFFFFFF, int(epoch)])
        )
        n = len(dataset)
        self.batches: list[tuple[np.ndarray, int | None]] = []

        if dataset.is_dynamic:
            lengths = dataset.seq_lengths
            edges = _bucket_edges_pow2(lengths, dataset.block_size)
            bucket_ids = bucket_for_lengths(lengths, edges)
            order = []
            for b, width in enumerate(edges):
                members = np.flatnonzero(bucket_ids == b)
                if members.size == 0:
                    continue
                if shuffle:
                    rng.shuffle(members)
                for start in range(0, len(members), self.batch_size):
                    chunk = members[start : start + self.batch_size]
                    if drop_last and len(chunk) < self.batch_size:
                        continue
                    order.append((chunk, int(width)))
            if shuffle:
                rng.shuffle(order)
            self.batches = order
        else:
            indices = np.arange(n)
            if shuffle:
                rng.shuffle(indices)
            for start in range(0, n, self.batch_size):
                chunk = indices[start : start + self.batch_size]
                if drop_last and len(chunk) < self.batch_size:
                    continue
                self.batches.append((chunk, dataset.block_size))

    def __len__(self) -> int:
        return len(self.batches)

    def microbatches(
        self, *, host_id: int = 0, n_hosts: int = 1, skip: int = 0,
        pad_equal_shards: bool = False, shard_multiple: int = 1,
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield (x, y) host-local microbatches, optionally skipping the
        first ``skip`` (mid-epoch resume).

        ``pad_equal_shards`` pads each host's shard with all-PAD rows to
        ``ceil(rows / n_hosts)`` — rounded up to a multiple of
        ``shard_multiple`` (the host's data-axis device count, so the
        assembled global batch tiles over every data shard) — so every
        process contributes an equal-shape local portion when assembling one
        global array (multi-process meshes); PAD rows carry no targets, so
        token-weighted reductions are unchanged.
        """
        mult = max(1, int(shard_multiple))
        for idx, (rows, width) in enumerate(self.batches):
            if idx < skip:
                continue
            local_rows = rows[host_id::n_hosts]
            x, y = self.dataset.fetch_batch(local_rows, pad_to=width)
            if pad_equal_shards and n_hosts > 1:
                want = -(-len(rows) // n_hosts)
                want = -(-want // mult) * mult
                if x.shape[0] < want:
                    pad = want - x.shape[0]
                    x = np.concatenate(
                        [x, np.zeros((pad,) + x.shape[1:], dtype=x.dtype)])
                    y = np.concatenate(
                        [y, np.zeros((pad,) + y.shape[1:], dtype=y.dtype)])
            yield x, y


def grouped_batches(
    plan: EpochPlan,
    gacc: int,
    *,
    host_id: int = 0,
    n_hosts: int = 1,
    skip_microbatches: int = 0,
    pad_batch_to: int | None = None,
):
    """Stack microbatches into (G, B, T) groups for the compiled step.

    The final group may have fewer microbatches (one extra jit
    specialization); the final microbatch is padded with all-PAD rows so B
    stays constant (PAD rows contribute no loss, no tokens).
    """
    group_x, group_y = [], []
    microbatch_index = skip_microbatches

    def emit():
        nonlocal group_x, group_y
        widths = {x.shape[1] for x in group_x}
        assert len(widths) == 1, "grouped microbatches must share one width"
        out = (
            np.stack(group_x),
            np.stack(group_y),
            microbatch_index,
        )
        group_x, group_y = [], []
        return out

    target_b = pad_batch_to
    for x, y in plan.microbatches(host_id=host_id, n_hosts=n_hosts, skip=skip_microbatches):
        if target_b is None:
            target_b = x.shape[0]
        if x.shape[0] < target_b:
            pad_rows = target_b - x.shape[0]
            x = np.concatenate([x, np.zeros((pad_rows, x.shape[1]), x.dtype)])
            y = np.concatenate([y, np.zeros((pad_rows, y.shape[1]), y.dtype)])
        # width changes (dynamic buckets) force a group boundary
        if group_x and (x.shape[1] != group_x[0].shape[1] or len(group_x) == gacc):
            yield emit()
        group_x.append(x)
        group_y.append(y)
        microbatch_index += 1
        if len(group_x) == gacc:
            yield emit()
    if group_x:
        yield emit()


class DevicePrefetcher:
    """Background-thread host→device prefetch over a batch iterator.

    A worker thread takes each host item from ``iterator``, applies
    ``transform`` (host work: a tuple of numpy arrays and plain values) and
    stages every numpy array of the result as a torch tensor on ``device``,
    filling a bounded queue ``depth`` deep. Batches, order and numerics are
    the plain iterator's; only the copies move off the consumer's path.

    On a CUDA device each array is copied into pinned host memory and then
    to the card with ``non_blocking=True`` on a side stream, and an event
    marks the end of the item's copies. The consumer's current stream waits
    on that event before anything uses the tensors, and each tensor is
    ``record_stream``-ed onto the consumer's stream, so the caching
    allocator does not hand its memory out again while that stream may
    still read it. Without the wait a step could read a half-copied batch;
    without ``record_stream`` a later allocation could overwrite it. On the
    CPU the arrays become tensors that share their memory.

    Use as an iterator; call ``close()`` (or use as a context manager) on
    early exit so the worker does not linger on a full queue.
    """

    _SENTINEL = object()

    def __init__(self, iterator, transform=lambda item: item, depth: int = 2,
                 *, device: str | torch.device = "cpu"):
        import queue as _queue
        import threading

        self.device = torch.device(device)
        self._queue_mod = _queue
        self._q = _queue.Queue(maxsize=max(1, int(depth)))
        self._err: BaseException | None = None
        self._stop = False
        self._done = False
        self._worker = threading.Thread(
            target=self._work, args=(iterator, transform), daemon=True
        )
        self._worker.start()

    def _stage(self, item, stream):
        """(item with numpy arrays as device tensors, copy-done event,
        the pinned sources kept alive until the consumer has waited)."""
        parts = item if isinstance(item, tuple) else (item,)
        if self.device.type != "cuda":
            out = tuple(torch.from_numpy(p) if isinstance(p, np.ndarray) else p
                        for p in parts)
            return (out if isinstance(item, tuple) else out[0]), None, ()
        pinned, out = [], []
        with torch.cuda.stream(stream):
            for p in parts:
                if isinstance(p, np.ndarray):
                    host = torch.from_numpy(np.ascontiguousarray(p)).pin_memory()
                    pinned.append(host)
                    p = host.to(self.device, non_blocking=True)
                out.append(p)
            event = torch.cuda.Event()
            event.record(stream)
        out = tuple(out)
        return (out if isinstance(item, tuple) else out[0]), event, tuple(pinned)

    def _work(self, iterator, transform):
        try:
            stream = (torch.cuda.Stream(device=self.device)
                      if self.device.type == "cuda" else None)
            for item in iterator:
                out = self._stage(transform(item), stream)
                while not self._stop:
                    try:
                        self._q.put(out, timeout=0.1)
                        break
                    except self._queue_mod.Full:
                        continue
                if self._stop:
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            while not self._stop:
                try:
                    self._q.put(self._SENTINEL, timeout=0.1)
                    break
                except self._queue_mod.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        out, event, _pinned = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in (out if isinstance(out, tuple) else (out,)):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(consumer)
        return out

    def close(self):
        """Stop the worker, drop queued batches and join the thread."""
        self._stop = True
        self._done = True
        try:
            while True:
                self._q.get_nowait()
        except self._queue_mod.Empty:
            pass
        self._worker.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


__all__ = [
    "DevicePrefetcher",
    "EpochPlan",
    "PackedDataset",
    "bucket_for_lengths",
    "build_codon_lm_datasets",
    "dataset_length_audit",
    "grouped_batches",
]
