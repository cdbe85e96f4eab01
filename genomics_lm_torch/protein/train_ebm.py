"""Latent EBM trainer: NCE over frozen-critic latents (twin of
``genomics_lm_tpu/protein/train_ebm.py``; the CLI is
``scripts/train_ebm.py``'s, plus ``--device``):

    python -m genomics_lm_torch.protein.train_ebm --config critic.yaml \
        --critic_ckpt .../best_critic.npz [--epochs 5] [--lr 1e-3] \
        [--hidden_dim 512] [--run_id protein_ebm] [--run_root runs] [--device cpu]

Negatives are 20% random-substitution corruptions of each real sequence,
drawn with Python's ``random`` seeded with ``--seed`` (so both packages
corrupt into the same strings); latents come from the frozen critic
(``requires_grad=False``) through ``extract_latent``; the loss is
``mean(softplus(E_pos - E_neg))`` under AdamW (optax semantics, decay
0.01). ``last_ebm.npz`` / ``best_ebm.npz`` (the EBM in the JAX tree
layout) and ``curves.csv``. A resume restores the EBM only and starts a
fresh optimizer, as JAX's does.
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from genomics_lm_torch.models.protein import (
    ProteinClassifierConfig,
    ebm_energy,
    extract_latent,
)
from genomics_lm_torch.protein import common
from genomics_lm_torch.protein.dataset import (
    MultiTaskProteinDataset,
    length_bucket_batches,
    pad_width_for,
)
from genomics_lm_torch.tokenizers.protein import AMINO_ACIDS, ProteinTokenizer
from genomics_lm_torch.training import checkpoints as ckpt_lib
from genomics_lm_torch.training.lifecycle import (
    TrainingRun,
    capture_rng_state,
    configuration_fingerprint,
)


def corrupt_sequence(seq: str, mutation_rate: float = 0.20, rng=None) -> str:
    """Random amino-acid substitutions at ``mutation_rate`` of positions."""
    rng = rng or random
    seq_list = list(seq)
    n_mutations = max(1, int(len(seq) * mutation_rate))
    indices = rng.sample(range(len(seq)), min(n_mutations, len(seq)))
    for idx in indices:
        seq_list[idx] = rng.choice(AMINO_ACIDS)
    return "".join(seq_list)


def encode_batch(tokenizer, seqs, width):
    B = len(seqs)
    ids = np.full((B, width), tokenizer.pad_token_id, np.int32)
    mask = np.zeros((B, width), np.int32)
    for i, seq in enumerate(seqs):
        t = (
            [tokenizer.bos_token_id]
            + tokenizer.encode_sequence(seq)[: width - 2]
            + [tokenizer.eos_token_id]
        )
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return ids, mask


def train(
    cfg: dict,
    critic_ckpt: str | Path,
    *,
    epochs: int = 5,
    lr: float = 1e-3,
    hidden_dim: int = 512,
    pooling: str = "attention",
    run_id: str = "protein_ebm",
    run_root: str | Path = "runs",
    resume: str | None = None,
    seed: int = 1337,
    device: str | torch.device | None = None,
    init_tree: dict | None = None,
) -> dict:
    """Train the EBM; ``init_tree`` (a JAX tree) replaces the fresh draw."""
    device = common.resolve_device(device)
    random.seed(seed)
    tokenizer = ProteinTokenizer()
    block_size = int(cfg.get("block_size", 512))

    model_cfg = ProteinClassifierConfig(
        vocab_size=len(tokenizer),
        n_layer=int(cfg["n_layer"]),
        n_head=int(cfg["n_head"]),
        n_embd=int(cfg["n_embd"]),
        block_size=block_size,
        dropout=float(cfg.get("dropout", 0.1)),
        pooling=pooling,
        num_classes=2,
    )
    critic = common.load_frozen(ckpt_lib.load_checkpoint(critic_ckpt), "multitask",
                                model_cfg, device)

    fingerprint = configuration_fingerprint(
        {**cfg, "critic_ckpt": str(Path(critic_ckpt).resolve()), "lr": lr,
         "pooling": pooling, "hidden_dim": hidden_dim, "seed": seed}
    )
    training_run = TrainingRun.open(
        run_root, run_id, resume=resume,
        last_checkpoint_name="last_ebm.npz",
        target_epochs=epochs, config_fingerprint=fingerprint,
    )

    train_ds = MultiTaskProteinDataset(cfg["train_data"], tokenizer, max_length=block_size)
    val_ds = MultiTaskProteinDataset(cfg["val_data"], tokenizer, max_length=block_size)
    batch_size = int(cfg.get("batch_size", 4))

    ebm = common.start_model("ebm", (int(cfg["n_embd"]), hidden_dim), device, seed=seed,
                             init_tree=init_tree)
    optimizer = common.adamw(ebm, lr, 0.01)

    @torch.no_grad()
    def latents(ids, mask):
        return extract_latent(critic, model_cfg, torch.as_tensor(ids, device=device),
                              torch.as_tensor(mask, device=device))

    def nce(z_pos, z_neg):
        e_pos, e_neg = ebm_energy(ebm, z_pos), ebm_energy(ebm, z_neg)
        return F.softplus(e_pos - e_neg).mean(), e_pos.mean(), e_neg.mean()

    curves = training_run.scores / "curves.csv"
    if not curves.exists():
        curves.write_text("epoch,train_loss,val_loss\n")
    best = float("inf")
    best_epoch = 0
    start_epoch = 1
    if resume:
        payload = ckpt_lib.load_checkpoint(resume)
        ebm = common.start_model("ebm", None, device, seed=seed, init_tree=payload["model"])
        optimizer = common.adamw(ebm, lr, 0.01)
        best = float(payload.get("best_val_loss", float("inf")))
        best_epoch = int(payload.get("best_epoch", 0))
        start_epoch = int(payload["epoch"]) + 1

    def epoch_pass(ds, epoch, train_mode):
        total, n = 0.0, 0
        for rows in length_bucket_batches(ds, batch_size, shuffle=train_mode, seed=seed,
                                          epoch=epoch):
            width = pad_width_for([ds.sequence_length(r) for r in rows])
            batch = ds.batch(rows, pad_to=width)
            neg_seqs = [corrupt_sequence(s, 0.20) for s in batch["sequence"]]
            neg_ids, neg_mask = encode_batch(tokenizer, neg_seqs, width)
            z_pos = latents(batch["input_ids"], batch["attention_mask"])
            z_neg = latents(neg_ids, neg_mask)
            if train_mode:
                loss, ep, en = nce(z_pos, z_neg)
                loss.backward()
                common.apply_accumulated(optimizer)
                if n % 50 == 0:
                    print(
                        f"[ebm] epoch {epoch} step {n} loss {float(loss.detach()):.4f} "
                        f"E_pos {float(ep.detach()):.3f} E_neg {float(en.detach()):.3f}"
                    )
            else:
                with torch.no_grad():
                    loss = nce(z_pos, z_neg)[0]
            total += float(loss.detach())
            n += 1
        return total / max(n, 1)

    history = []
    for epoch in range(start_epoch, epochs + 1):
        avg_train = epoch_pass(train_ds, epoch, True)
        avg_val = epoch_pass(val_ds, 0, False)
        print(f"[ebm] epoch {epoch} train {avg_train:.4f} val {avg_val:.4f}")
        with curves.open("a") as f:
            f.write(f"{epoch},{avg_train:.4f},{avg_val:.4f}\n")
        history.append({"epoch": epoch, "train_loss": avg_train, "val_loss": avg_val})
        payload = {
            "model": common.protein_params_to_jax(ebm),
            "epoch": epoch,
            "val_loss": avg_val,
            "best_val_loss": min(best, avg_val),
            "best_epoch": epoch if avg_val < best else best_epoch,
            "rng_state": capture_rng_state(),
            "run_fingerprint": fingerprint,
            "run_progress": {
                "completed_epochs": epoch, "current_epoch": epoch,
                "microbatch": 0, "optimizer_step": epoch,
            },
        }
        ckpt_lib.save_checkpoint(payload, training_run.checkpoints / "last_ebm.npz")
        if avg_val < best:
            best = avg_val
            best_epoch = epoch
            ckpt_lib.save_checkpoint(payload, training_run.checkpoints / "best_ebm.npz")
            print(f"[saved] best_ebm.npz (new best validation loss: {best:.4f})")

    meta = {"status": "completed", "best_epoch": best_epoch, "best_val_loss": best,
            "history": history}
    (training_run.scores / "metrics.json").write_text(json.dumps(meta, indent=2))
    training_run.mark_complete({"completed_epochs": epochs})
    training_run.close()
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the protein latent EBM")
    ap.add_argument("--config", required=True, help="critic config YAML")
    ap.add_argument("--critic_ckpt", required=True)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--pooling", default="attention")
    ap.add_argument("--hidden_dim", type=int, default=512)
    ap.add_argument("--run_id", default="protein_ebm")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}
    train(
        cfg, args.critic_ckpt, epochs=args.epochs, lr=args.lr,
        hidden_dim=args.hidden_dim, pooling=args.pooling, run_id=args.run_id,
        run_root=args.run_root, resume=args.resume, seed=args.seed, device=args.device,
    )
    return 0


__all__ = ["corrupt_sequence", "encode_batch", "main", "train"]


if __name__ == "__main__":
    raise SystemExit(main())
