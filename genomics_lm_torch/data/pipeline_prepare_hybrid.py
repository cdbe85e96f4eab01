"""Hybrid dataset preparation CLI: config-driven GBFF → combined training
set (twin of ``scripts/pipeline_prepare_hybrid.py``, the same flags).

    python -m genomics_lm_torch.data.pipeline_prepare_hybrid --config cfg.yaml \\
        --run-id RUN --run-dir prep [--out-root data/processed] [--force] \\
        [--upstream 30] [--downstream 60] [--pack_mode multi] \\
        [--extra-dataset NAME,GBFF[,MIN_LEN]]

The YAML holds ``datasets: [{name, gbff[, min_len]}]`` and ``block_size``,
``windows_per_seq``, ``val_frac``, ``test_frac`` (optionally under ``data:``).
Extraction, hybrid tokenization, genome-group split, packing, stacking,
manifests and the pad-only-window integrity gate (exit code 3) run in
process (``data/hybrid_pipeline.py``). The combined directory's ``itos.txt``
binds the 74-token vocabulary for the train CLI. Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def _parse_extra_dataset(spec: str) -> dict:
    parts = spec.split(",")
    if len(parts) < 2:
        raise SystemExit(
            f"[error] bad --extra-dataset spec (need name,gbff[,min_len]): {spec}")
    entry: dict = {"name": parts[0], "gbff": parts[1]}
    if len(parts) > 2:
        entry["min_len"] = int(parts[2])
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Prepare hybrid multi-scale datasets for training")
    ap.add_argument("--config", required=True)
    ap.add_argument("--run-id", required=True)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--out-root", default="data/processed",
                    help="root for per-dataset and combined artifacts")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--upstream", type=int, default=30)
    ap.add_argument("--downstream", type=int, default=60)
    ap.add_argument("--pack_mode",
                    choices=["single", "multi", "dynamic", "binpack"],
                    default="multi")
    ap.add_argument("--extra-dataset", action="append", default=[],
                    help="NAME,GBFF[,MIN_LEN]")
    args = ap.parse_args(argv)

    import yaml

    from genomics_lm_torch.data.hybrid_pipeline import (
        HybridIntegrityError,
        HybridPipelineError,
        prepare_hybrid_datasets,
    )

    cfg = yaml.safe_load(Path(args.config).read_text()) or {}
    if not isinstance(cfg, dict):
        raise SystemExit(f"[error] config at {args.config} must be a mapping")

    try:
        result = prepare_hybrid_datasets(
            cfg,
            run_dir=args.run_dir,
            run_id=args.run_id,
            out_root=args.out_root,
            upstream=args.upstream,
            downstream=args.downstream,
            force=args.force,
            extra_datasets=[_parse_extra_dataset(s) for s in args.extra_dataset],
            pack_mode=args.pack_mode,
        )
    except HybridIntegrityError as exc:
        print(f"[integrity] {exc}")
        return 3
    except HybridPipelineError as exc:
        raise SystemExit(f"[error] {exc}")

    print(f"[prepare] train={result['train_npz']}")
    print(f"[prepare] val={result['val_npz']}")
    print(f"[prepare] test={result['test_npz']}")
    print(f"[prepare] wrote {Path(args.run_dir) / 'pipeline_prepare.json'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
