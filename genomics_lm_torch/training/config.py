"""Run-config helpers: meta writing, run IDs, offset-weight normalization.

Twin of ``genomics_lm_tpu/training/config.py`` (parity: reference
``src/codonlm/training/config.py``), copied verbatim.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

RUN_ID_ENV = "RUN_ID"


def write_meta(run_dir: Path, meta: dict) -> None:
    """Write ``meta.json`` and refresh the cross-run summary (best effort)."""
    meta_path = Path(run_dir) / "meta.json"
    meta_path.write_text(json.dumps(meta, indent=2, sort_keys=True) + "\n")
    try:
        from genomics_lm_torch.evals.summaries import generate_summary

        generate_summary(Path(run_dir).parent)
    except Exception as exc:  # summary generation must never fail a run
        print(f"[warning] Failed to generate summary.md: {exc}", file=sys.stderr)


def ensure_path_list(arg_value, cfg_value, key: str) -> list[str]:
    source = arg_value if arg_value is not None else cfg_value
    if source is None:
        raise ValueError(f"Missing {key} specification (provide in config or CLI)")
    if isinstance(source, (str, os.PathLike)):
        return [str(source)]
    if isinstance(source, (list, tuple)):
        return [str(p) for p in source]
    raise TypeError(f"Unsupported {key} type: {type(source)}")


def normalize_run_id(value: str | None) -> str | None:
    if value is None:
        return None
    run_id = str(value).strip()
    return run_id or None


def auto_run_id(cfg: dict, config_path: str | None) -> str:
    """``YYYY-MM-DD_tag_NLNH_dD_eE`` (reference config.py:37-44)."""
    from datetime import date

    today = date.today().strftime("%Y-%m-%d")
    tag = "run"
    if config_path:
        stem = Path(config_path).stem
        tag = stem.split("_", 1)[0] if "_" in stem else stem
    n_embd = cfg.get("n_embd") or (
        int(cfg.get("d_head", 0)) * int(cfg.get("n_head", 0))
    )
    return (
        f"{today}_{tag}_{int(cfg.get('n_layer', 0))}L{int(cfg.get('n_head', 0))}H"
        f"_d{int(n_embd or 0)}_e{int(cfg.get('epochs', 0) or 0)}"
    )


def normalize_offset_weights(offsets, weights_cfg=None) -> dict[int, float]:
    """dict / list / scalar / None → {offset: weight} (config.py:61-74)."""
    offsets = [int(o) for o in offsets]
    if not offsets:
        return {}
    if weights_cfg is None:
        return {o: 1.0 / len(offsets) for o in offsets}
    if isinstance(weights_cfg, dict):
        return {
            o: float(weights_cfg.get(o, weights_cfg.get(str(o), 0.0))) for o in offsets
        }
    if isinstance(weights_cfg, (list, tuple)):
        if len(weights_cfg) != len(offsets):
            raise ValueError(
                "multi_offset_weights list must match multi_offset_targets length"
            )
        return {o: float(w) for o, w in zip(offsets, weights_cfg)}
    scalar = float(weights_cfg)
    return {o: scalar for o in offsets}


def load_yaml_config(path: str | Path) -> dict:
    """Flat YAML config; a ``data:`` sub-map merges into the flat namespace
    (parity: ``train_codon_lm.py:49-52``)."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    data_map = cfg.pop("data", None)
    if isinstance(data_map, dict):
        for key, value in data_map.items():
            cfg.setdefault(key, value)
    return cfg


__all__ = [
    "RUN_ID_ENV",
    "auto_run_id",
    "ensure_path_list",
    "load_yaml_config",
    "normalize_offset_weights",
    "normalize_run_id",
    "write_meta",
]
