"""Protein LM data: JSONL/FASTA sequence loading with conditional tokens (the
port's copy of ``genomics_lm_tpu/protein/data.py``, numpy only).

Parity: reference ``src/protein_lm/data.py`` — JSONL records with
``sequence`` plus optional ``func_label``/``topo_label`` become
``[BOS] <FUNC:...> <TOPO:...> sequence`` padded/truncated to ``block_size``.
FASTA files are accepted for convenience (plain sequences, no conditions).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def load_records(path: str | Path) -> list[dict]:
    """JSONL records, or FASTA converted to ``{"sequence": ...}`` records."""
    path = Path(path)
    records: list[dict] = []
    text = path.read_text()
    if text.lstrip().startswith(">"):
        seq_lines: list[str] = []
        for line in text.splitlines():
            if line.startswith(">"):
                if seq_lines:
                    records.append({"sequence": "".join(seq_lines)})
                    seq_lines = []
            else:
                seq_lines.append(line.strip())
        if seq_lines:
            records.append({"sequence": "".join(seq_lines)})
        return records
    for line in text.splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return records


def load_sequences(path: str | Path) -> list[str]:
    return [r["sequence"] for r in load_records(path)]


def encode_record(record: dict, tokenizer, block_size: int) -> np.ndarray:
    """``[BOS] + conditions + sequence`` padded/truncated to block_size."""
    conditions = []
    if "func_label" in record:
        conditions.append(f"<FUNC:{record['func_label'].upper()}>")
    if "topo_label" in record:
        conditions.append(f"<TOPO:{record['topo_label'].upper()}>")
    input_ids = (
        [tokenizer.bos_token_id]
        + tokenizer.encode_conditions(conditions)
        + tokenizer.encode_sequence(record["sequence"])
    )
    out = np.full(block_size, tokenizer.pad_token_id, np.int32)
    ids = input_ids[:block_size]
    out[: len(ids)] = ids
    return out


def encode_dataset(path: str | Path, tokenizer, block_size: int) -> np.ndarray:
    return np.stack(
        [encode_record(r, tokenizer, block_size) for r in load_records(path)]
    )


__all__ = ["encode_dataset", "encode_record", "load_records", "load_sequences"]
