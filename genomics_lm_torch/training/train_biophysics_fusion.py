"""Pretrain the DNA-shape encoder and optionally chain into shape-guided LM
training (twin of ``scripts/train_biophysics_fusion.py``, the same flags
plus ``--device``).

    python -m genomics_lm_torch.training.train_biophysics_fusion \\
        [--out_checkpoint outputs/shape_encoder.npz] [--lm_config cfg.yaml] \\
        [--device cuda:0]

The encoder (``models/biophysics.py::train_encoder``) is saved as
``{"encoder": tree, "losses": [...]}`` in the JAX ``.npz`` layout, which
both packages' trainers read as ``shape_encoder_checkpoint``. With
``--lm_config`` the port's trainer then runs that config with
``use_shape_guidance: true`` and the new checkpoint. Everything runs on
``--device`` (default: the CUDA card; raises without one).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_checkpoint", default="outputs/shape_encoder.npz")
    ap.add_argument("--num_samples", type=int, default=5000)
    ap.add_argument("--seq_len_codons", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm_config", default=None,
                    help="optionally chain into shape-guided LM training")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.models.biophysics import encoder_tree, train_encoder
    from genomics_lm_torch.training.checkpoints import save_checkpoint

    encoder, losses = train_encoder(
        num_samples=args.num_samples, seq_len_codons=args.seq_len_codons,
        epochs=args.epochs, lr=args.lr, seed=args.seed, device=args.device,
    )
    out = Path(args.out_checkpoint)
    save_checkpoint({"encoder": encoder_tree(encoder), "losses": [float(v) for v in losses]},
                    out)
    print(f"[biophysics] encoder MSE {losses[0]:.4f} → {losses[-1]:.4f}; saved {out}")

    if args.lm_config:
        from genomics_lm_torch.training.config import load_yaml_config
        from genomics_lm_torch.training.loop import run_training

        cfg = load_yaml_config(args.lm_config)
        cfg["use_shape_guidance"] = True
        cfg["shape_encoder_checkpoint"] = str(out)
        run_training(cfg, config_path=args.lm_config, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
