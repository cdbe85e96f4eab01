"""Print the canonical run id of a config (twin of ``scripts/make_run_id.py``;
host only).

    python -m genomics_lm_torch.training.make_run_id config.yaml

The config's ``run_id``, normalized, or the id ``auto_run_id`` derives
from the config and its file name.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    args = ap.parse_args(argv)

    from genomics_lm_torch.training.config import (
        auto_run_id,
        load_yaml_config,
        normalize_run_id,
    )

    cfg = load_yaml_config(args.config)
    print(normalize_run_id(cfg.get("run_id")) or auto_run_id(cfg, args.config))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
