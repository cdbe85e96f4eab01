"""NoProp trainer with run lifecycle (twin of
``genomics_lm_tpu/training/train_noprop.py`` and ``scripts/train_noprop.py``).

The vocabulary contract and the ``TrainingRun`` directory of the codon
trainer, per-epoch train and validation cross-entropy in
``scores/curves.csv``, noisy target embeddings of configurable sigma, and
one AdamW (optax ``adamw``'s defaults: betas 0.9/0.999, eps 1e-8, weight
decay 1e-4) over the layer-local loss of ``models/noprop.py``. The model
and the noise generator start from ``seed``. Checkpoints are the JAX
``.npz`` container with the model in the JAX tree layout; a resume, as in
JAX, reloads the weights and the best validation loss and continues at
the next epoch with a fresh optimizer and the noise stream from ``seed``.

    python -m genomics_lm_torch.training.train_noprop --config cfg.yaml \\
        [--run_id ID] [--noise_sigma 0.1] [--resume runs/ID/checkpoints/last.npz] \\
        [--run_root runs] [--device cpu]

The config needs ``train_npz``, ``val_npz``, ``block_size`` and
``batch_size``; ``n_layer``, ``n_head``, ``n_embd``, ``learning_rate``,
``epochs``, ``seed``, ``sep_mask_enabled`` and ``itos_path`` are optional.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from genomics_lm_torch.data import vocabulary as vocab_lib
from genomics_lm_torch.data.datasets import EpochPlan, PackedDataset
from genomics_lm_torch.models import noprop
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.losses import cross_entropy
from genomics_lm_torch.training import checkpoints as ckpt_lib
from genomics_lm_torch.training.config import ensure_path_list, load_yaml_config
from genomics_lm_torch.training.lifecycle import (
    TrainingRun,
    capture_rng_state,
    configuration_fingerprint,
)
from genomics_lm_torch.utils.device import resolve_device


def run_training(
    cfg: dict,
    *,
    noise_sigma: float = 0.1,
    run_id: str | None = None,
    resume: str | None = None,
    run_root: str | Path = "runs",
    device: str | torch.device | None = None,
) -> dict:
    device = resolve_device(device)
    train_paths = ensure_path_list(None, cfg.get("train_npz"), "train_npz")
    val_paths = ensure_path_list(None, cfg.get("val_npz"), "val_npz")
    contract = vocab_lib.resolve_vocabulary_contract(
        [*train_paths, *val_paths],
        configured_path=cfg.get("itos_path"),
        configured_size=cfg.get("vocab_size"),
    )
    cfg = dict(cfg)
    cfg["vocab_size"] = contract.size

    epochs = int(cfg.get("epochs", 5))
    fingerprint = configuration_fingerprint({**cfg, "noise_sigma": noise_sigma})
    training_run = TrainingRun.open(
        run_root, run_id or cfg.get("run_id") or "noprop",
        resume=resume, target_epochs=epochs, config_fingerprint=fingerprint,
    )
    snapshot = vocab_lib.snapshot_vocabulary(contract, training_run.run_dir / "itos.txt")
    vocab_lib.write_vocabulary_manifest(
        contract.provenance(snapshot), training_run.run_dir / "vocabulary.json"
    )

    model_cfg = CodonGPTConfig(
        vocab_size=contract.size,
        block_size=int(cfg["block_size"]),
        n_layer=int(cfg.get("n_layer", 3)),
        n_head=int(cfg.get("n_head", 4)),
        n_embd=int(cfg.get("n_embd", 256)),
        dropout=float(cfg.get("dropout", 0.1)),
        sep_id=3 if cfg.get("sep_mask_enabled", True) else None,
    )
    train_ds = PackedDataset(train_paths)
    val_ds = PackedDataset(val_paths)
    batch_size = int(cfg["batch_size"])
    seed = int(cfg.get("seed", 1337))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = noprop.NoPropGPT(model_cfg)
    generator = torch.Generator(device=device).manual_seed(seed)
    start_epoch = 1
    best = float("inf")
    if resume:
        payload = ckpt_lib.load_checkpoint(resume)
        model = noprop.params_from_jax(payload["model"], model_cfg, "cpu")
        best = float(payload.get("best_val_loss", float("inf")))
        start_epoch = int(payload["epoch"]) + 1
    model = model.to(device)
    lr = float(cfg.get("learning_rate", 5e-4))
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)

    def batch(a):
        return torch.from_numpy(a).to(device).long()

    curves = training_run.scores / "curves.csv"
    if not curves.exists():
        curves.write_text("epoch,train_ce,val_ce\n")

    history = []
    for epoch in range(start_epoch, epochs + 1):
        plan = EpochPlan(train_ds, batch_size=batch_size, seed=seed, epoch=epoch)
        ce_sum, n = 0.0, 0
        for x, y in plan.microbatches():
            total, parts = noprop.noprop_loss(model, model_cfg, batch(x), batch(y), generator,
                                              noise_sigma=noise_sigma)
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            optimizer.step()
            ce_sum += float(parts["ce"].detach())
            n += 1
        val_plan = EpochPlan(val_ds, batch_size=batch_size, seed=seed, epoch=0, shuffle=False)
        val_sum, vn = 0.0, 0
        with torch.no_grad():
            for x, y in val_plan.microbatches():
                logits, _ = noprop.forward(model, model_cfg, batch(x))
                val_sum += float(cross_entropy(logits, batch(y), ignore_index=0))
                vn += 1
        train_loss = ce_sum / max(n, 1)
        val_loss = val_sum / max(vn, 1)
        print(f"[noprop] epoch {epoch} train_ce {train_loss:.4f} val_ce {val_loss:.4f}")
        with curves.open("a") as f:
            f.write(f"{epoch},{train_loss:.4f},{val_loss:.4f}\n")
        history.append({"epoch": epoch, "train_ce": train_loss, "val_ce": val_loss})
        payload = {
            "model": noprop.params_to_jax(model),
            "cfg": cfg,
            "epoch": epoch,
            "val_loss": val_loss,
            "best_val_loss": min(best, val_loss),
            "noise_sigma": noise_sigma,
            "rng_state": capture_rng_state(generator),
            "run_fingerprint": fingerprint,
            "run_progress": {"completed_epochs": epoch, "current_epoch": epoch,
                             "microbatch": 0, "optimizer_step": epoch * max(n, 1)},
        }
        ckpt_lib.save_checkpoint(payload, training_run.checkpoints / "last.npz")
        if val_loss < best:
            best = val_loss
            ckpt_lib.save_checkpoint(payload, training_run.checkpoints / "best.npz")

    meta = {"status": "completed", "best_val_loss": best, "history": history}
    (training_run.scores / "metrics.json").write_text(json.dumps(meta, indent=2))
    training_run.mark_complete({"completed_epochs": epochs})
    training_run.close()
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="NoProp codon LM trainer")
    ap.add_argument("--config", required=True)
    ap.add_argument("--run_id", default=None)
    ap.add_argument("--noise_sigma", type=float, default=0.1)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = load_yaml_config(args.config)
    run_training(cfg, noise_sigma=args.noise_sigma, run_id=args.run_id,
                 resume=args.resume, run_root=args.run_root, device=args.device)
    return 0


__all__ = ["main", "run_training"]


if __name__ == "__main__":
    raise SystemExit(main())
