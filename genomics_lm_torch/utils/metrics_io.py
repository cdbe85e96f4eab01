"""Read and merge-write ``metrics.json`` (twin of
``genomics_lm_tpu/utils/metrics_io.py``): the same bytes, ``indent=2``,
sorted keys and a trailing newline; a missing or corrupt file reads as
``{}``."""

from __future__ import annotations

import json
from pathlib import Path


def read_metrics(path: str | Path) -> dict:
    path = Path(path)
    if not path.exists():
        return {}
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError:
        return {}


def write_metrics(path: str | Path, updates: dict) -> dict:
    """Merge ``updates`` into the existing metrics file and rewrite it."""
    path = Path(path)
    merged = read_metrics(path)
    merged.update(updates)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(merged, indent=2, sort_keys=True) + "\n")
    return merged


__all__ = ["read_metrics", "write_metrics"]
