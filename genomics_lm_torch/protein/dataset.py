"""Protein datasets: multi-task JSONL records with length bucketing (the
port's copy of ``genomics_lm_tpu/protein/dataset.py``, numpy only).

Parity: reference ``src/protein_lm/dataset.py`` — BOS/EOS wrapping,
truncation to ``max_length``, fixed or dynamic padding, family/function ids
(``pfam_id``/``ec_id``), stability as regression score (NaN when missing) or
class id, optional multi-label float vectors. Numpy-native batches padded to
power-of-two bucket widths for shape-stable compilation.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class MultiTaskProteinDataset:
    def __init__(
        self,
        jsonl_path,
        tokenizer,
        max_length: int = 512,
        multi_label_tasks=None,
    ):
        self.tokenizer = tokenizer
        self.max_length = int(max_length)
        self.multi_label_tasks = sorted(set(multi_label_tasks or []))
        self.samples: list[dict] = []
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.samples.append(json.loads(line))

    def __len__(self) -> int:
        return len(self.samples)

    def sequence_length(self, idx: int) -> int:
        return min(len(self.samples[idx]["sequence"]) + 2, self.max_length)

    def encode(self, idx: int) -> list[int]:
        s = self.samples[idx]
        return (
            [self.tokenizer.bos_token_id]
            + self.tokenizer.encode_sequence(s["sequence"])[: self.max_length - 2]
            + [self.tokenizer.eos_token_id]
        )

    def batch(self, indices, *, pad_to: int | None = None) -> dict:
        """Gather a padded batch dict of numpy arrays."""
        tokens = [self.encode(int(i)) for i in indices]
        width = pad_to or max(len(t) for t in tokens)
        B = len(indices)
        input_ids = np.full((B, width), self.tokenizer.pad_token_id, np.int32)
        attention_mask = np.zeros((B, width), np.int32)
        for row, t in enumerate(tokens):
            t = t[:width]
            input_ids[row, : len(t)] = t
            attention_mask[row, : len(t)] = 1

        family = np.asarray(
            [self.samples[int(i)].get("pfam_id", -1) for i in indices], np.int32
        )
        function = np.asarray(
            [self.samples[int(i)].get("ec_id", -1) for i in indices], np.int32
        )
        stab_scores = []
        stab_is_reg = any("stability_score" in self.samples[int(i)] for i in indices)
        for i in indices:
            s = self.samples[int(i)]
            if stab_is_reg:
                v = s.get("stability_score")
                stab_scores.append(float(v) if v is not None else np.nan)
            else:
                stab_scores.append(s.get("stability_id", -1))
        stability = np.asarray(
            stab_scores, np.float32 if stab_is_reg else np.int32
        )
        out = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "sequence": [self.samples[int(i)]["sequence"] for i in indices],
            "family": family,
            "function": function,
            "stability": stability,
        }
        for task in self.multi_label_tasks:
            rows = []
            for i in indices:
                s = self.samples[int(i)]
                labels = s.get(task)
                if labels is None:
                    labels = s.get(f"{task}_labels") or []
                rows.append(np.asarray(labels, np.float32))
            if rows:
                n = max((r.size for r in rows), default=0)
                mat = np.zeros((B, n), np.float32)
                for r_i, r in enumerate(rows):
                    mat[r_i, : r.size] = r
                out[task] = mat
        return out


def length_bucket_batches(
    dataset: MultiTaskProteinDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 1337,
    epoch: int = 0,
):
    """Sort-by-length batching with epoch-seeded batch shuffle
    (parity: ``LengthBucketBatchSampler``). Yields index lists."""
    rng = np.random.default_rng(int(seed) + int(epoch))
    indices = sorted(range(len(dataset)), key=dataset.sequence_length)
    batches = [
        indices[i : i + int(batch_size)]
        for i in range(0, len(indices), int(batch_size))
    ]
    if shuffle:
        rng.shuffle(batches)
    yield from batches


def pad_width_for(lengths, *, minimum: int = 16) -> int:
    """Smallest power-of-two width covering the batch (bounds recompiles)."""
    need = max(int(max(lengths)), 1)
    width = minimum
    while width < need:
        width *= 2
    return width


__all__ = ["MultiTaskProteinDataset", "length_bucket_batches", "pad_width_for"]
