"""Standalone MLP heads over frozen critic features (twin of
``genomics_lm_tpu/protein/train_mlp_heads.py``; the CLI is
``scripts/train_mlp_heads.py``'s, plus ``--device``):

    python -m genomics_lm_torch.protein.train_mlp_heads --config critic.yaml \
        --critic_ckpt .../best_critic.npz [--epochs 20] [--hidden 128] \
        [--lr 1e-3] [--out_dir runs/protein_mlp_heads] [--device cpu]

The frozen critic's bottleneck latents are extracted once for each split
(length-bucketed batches of 16 on the device), then one small MLP per task
trains on them through ``evals/probes.py::fit_mlp`` on the same device;
``metrics.json`` holds each task's training metrics and validation accuracy.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.models.protein import ProteinClassifierConfig, extract_latent
from genomics_lm_torch.protein import common
from genomics_lm_torch.protein.dataset import (
    MultiTaskProteinDataset,
    length_bucket_batches,
    pad_width_for,
)
from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
from genomics_lm_torch.training import checkpoints as ckpt_lib


@torch.no_grad()
def extract_features(critic, critic_cfg, dataset, *, batch_size=16):
    """Frozen bottleneck latents for every dataset record, on the critic's device."""
    device = next(critic.parameters()).device
    feats = np.zeros((len(dataset), critic_cfg.n_embd), np.float32)
    for rows in length_bucket_batches(dataset, batch_size, shuffle=False):
        width = pad_width_for([dataset.sequence_length(r) for r in rows])
        batch = dataset.batch(rows, pad_to=width)
        z = extract_latent(critic, critic_cfg,
                           torch.as_tensor(batch["input_ids"], device=device),
                           torch.as_tensor(batch["attention_mask"], device=device))
        feats[np.asarray(rows)] = z.cpu().numpy()
    return feats


def train(
    cfg: dict,
    critic_ckpt: str | Path,
    *,
    tasks: dict[str, str] | None = None,
    hidden: int = 128,
    epochs: int = 20,
    lr: float = 1e-3,
    batch_size: int = 64,
    seed: int = 0,
    out_dir: str | Path = "runs/protein_mlp_heads",
    device: str | torch.device | None = None,
) -> dict:
    """Train per-task MLP heads on frozen features; returns the report."""
    device = common.resolve_device(device)
    tokenizer = ProteinTokenizer()
    block_size = int(cfg.get("block_size", 512))
    tasks = tasks or {"family": "family", "function": "function"}

    critic_cfg = ProteinClassifierConfig(
        vocab_size=len(tokenizer),
        n_layer=int(cfg["n_layer"]), n_head=int(cfg["n_head"]),
        n_embd=int(cfg["n_embd"]), block_size=block_size,
        dropout=0.0, pooling=str(cfg.get("pooling", "mean")),
    )
    critic = common.load_frozen(ckpt_lib.load_checkpoint(critic_ckpt), "multitask",
                                critic_cfg, device)
    train_ds = MultiTaskProteinDataset(cfg["train_data"], tokenizer, max_length=block_size)
    val_ds = MultiTaskProteinDataset(cfg["val_data"], tokenizer, max_length=block_size)
    X_train = extract_features(critic, critic_cfg, train_ds)
    X_val = extract_features(critic, critic_cfg, val_ds)

    from genomics_lm_torch.evals.probes import fit_mlp

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {}
    for task, label_key in tasks.items():
        tb = train_ds.batch(list(range(len(train_ds))))
        vb = val_ds.batch(list(range(len(val_ds))))
        y_train = np.asarray(tb[label_key])
        y_val = np.asarray(vb[label_key])
        keep = y_train >= 0
        if keep.sum() < 2 or len(np.unique(y_train[keep])) < 2:
            report[task] = {"skipped": "insufficient labels"}
            continue
        result = fit_mlp(
            X_train[keep], y_train[keep], epochs=epochs, hidden=hidden,
            lr=lr, batch_size=batch_size, seed=seed, device=device,
        )
        vkeep = y_val >= 0
        if vkeep.any():
            preds, _ = result.predict_fn(X_val[vkeep])
            val_acc = float((preds == y_val[vkeep]).mean())
        else:
            val_acc = None
        report[task] = {"train_metrics": result.metrics, "val_accuracy": val_acc}
    (out_dir / "metrics.json").write_text(json.dumps(report, indent=2, default=str) + "\n")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="critic config YAML")
    ap.add_argument("--critic_ckpt", required=True)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out_dir", default="runs/protein_mlp_heads")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}
    report = train(
        cfg, args.critic_ckpt, epochs=args.epochs, hidden=args.hidden,
        lr=args.lr, out_dir=args.out_dir, device=args.device,
    )
    print(json.dumps(report, indent=2, default=str))
    return 0


__all__ = ["extract_features", "main", "train"]


if __name__ == "__main__":
    raise SystemExit(main())
