"""Generated-state replay batches (twin of ``genomics_lm_tpu/data/replay.py``).

A numpy copy of the JAX module: a JSONL file of generated contexts (``ids``
plus sparse termination labels, either a ``labels`` list of ``{"pos",
"class"}`` entries or the legacy scalar pair ``label_position``/
``target_class``) becomes fixed-length rows. Contexts longer than
``block_size`` keep their tail (left clip), label positions shift with
it, labels outside the kept window are dropped, and rows with no
surviving label are excluded. Targets are ``IGNORE_INDEX`` except at
supervised positions. Everything is materialized into two dense int32
matrices at load time, so a batch is a row slice; ``batches`` draws the
same endless shuffled sequence as the JAX iterator for the same seed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

IGNORE_INDEX = -100


class ReplayFormatError(ValueError):
    """A replay JSONL line that cannot be parsed at all."""


def _parse_line(raw: str, where: str) -> dict | None:
    text = raw.strip()
    if not text:
        return None
    try:
        return json.loads(text)
    except json.JSONDecodeError as exc:
        raise ReplayFormatError(f"invalid JSONL record at {where}: {exc}") from exc


def _extract_labels(record: dict) -> list[tuple[int, int]]:
    """Sparse (position, class) pairs; tolerates either schema, skips junk."""
    entries = record.get("labels")
    if entries is None and {"label_position", "target_class"} <= record.keys():
        entries = [{"pos": record["label_position"], "class": record["target_class"]}]
    pairs: list[tuple[int, int]] = []
    for entry in entries if isinstance(entries, list) else ():
        if isinstance(entry, dict):
            try:
                pairs.append((int(entry["pos"]), int(entry["class"])))
            except (KeyError, TypeError, ValueError):
                pass
    return pairs


def _extract_ids(record: dict) -> list[int] | None:
    raw = record.get("ids")
    if not isinstance(raw, list) or not raw:
        return None
    try:
        return [int(t) for t in raw]
    except (TypeError, ValueError):
        return None


class GeneratedTerminationReplayDataset:
    """Dense (N, block_size) x/label matrices built from a replay JSONL."""

    def __init__(
        self,
        path: str | Path,
        block_size: int,
        *,
        pad_id: int = 0,
        ignore_index: int = IGNORE_INDEX,
    ) -> None:
        self.path = Path(path)
        self.block_size = int(block_size)
        self.pad_id = int(pad_id)
        self.ignore_index = int(ignore_index)
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        if not self.path.exists():
            raise FileNotFoundError(f"replay dataset not found: {self.path}")

        rows_x: list[np.ndarray] = []
        rows_y: list[np.ndarray] = []
        with self.path.open() as fh:
            for lineno, raw in enumerate(fh, start=1):
                record = _parse_line(raw, f"{self.path}:{lineno}")
                if record is None:
                    continue
                row = self._materialize(record)
                if row is not None:
                    rows_x.append(row[0])
                    rows_y.append(row[1])
        if not rows_x:
            raise ValueError(f"replay dataset has no usable records: {self.path}")
        self.x = np.stack(rows_x)
        self.y = np.stack(rows_y)

    def _materialize(self, record: dict) -> tuple[np.ndarray, np.ndarray] | None:
        """One record → (x_row, y_row), or None when nothing supervises it."""
        ids = _extract_ids(record)
        if ids is None:
            return None
        pairs = _extract_labels(record)
        if not pairs:
            return None
        clip_start = max(0, len(ids) - self.block_size)
        kept = ids[clip_start:]
        y_row = np.full(self.block_size, self.ignore_index, dtype=np.int32)
        any_label = False
        for pos, cls in pairs:
            shifted = pos - clip_start
            if 0 <= shifted < len(kept):
                y_row[shifted] = cls
                any_label = True
        if not any_label:
            return None
        x_row = np.full(self.block_size, self.pad_id, dtype=np.int32)
        x_row[: len(kept)] = kept
        return x_row, y_row

    def __len__(self) -> int:
        return self.x.shape[0]

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        return self.x[idx], self.y[idx]

    def batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        sel = np.asarray(indices, dtype=np.int64)
        return self.x[sel], self.y[sel]

    def batches(self, batch_size: int, *, seed: int = 0):
        """Endless shuffled full-batch iterator (replay loaders cycle)."""
        rng = np.random.default_rng(seed)
        n = len(self)
        while True:
            order = rng.permutation(n)
            for lo in range(0, n - batch_size + 1, batch_size):
                yield self.batch(order[lo : lo + batch_size])


__all__ = ["GeneratedTerminationReplayDataset", "IGNORE_INDEX", "ReplayFormatError"]
