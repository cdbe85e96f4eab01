"""Protein LM trainer CLI (twin of ``scripts/train_protein_lm.py``, the same
flags plus ``--device``):

    python -m genomics_lm_torch.protein.train_protein_lm --config plm.yaml \
        [--resume runs/protein_lm/<id>/checkpoints/last.npz] [--run-id ID] \
        [--run_root runs/protein_lm] [--device cpu]

The YAML holds ``model:``, ``training:`` and ``data:`` maps
(``protein/train_lm.py``).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train a protein language model")
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--run-id", dest="run_id", default=None)
    ap.add_argument("--run_root", default="runs/protein_lm")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import yaml

    from genomics_lm_torch.protein.train_lm import train

    with open(args.config) as f:
        config = yaml.safe_load(f) or {}
    train(config, resume=args.resume, run_id=args.run_id, run_root=args.run_root,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
