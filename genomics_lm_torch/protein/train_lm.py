"""Protein LM trainer: next-token CE with per-epoch cosine annealing (twin of
``genomics_lm_tpu/protein/train_lm.py``; its CLI is ``train_protein_lm``).

CE (ignoring PAD) on shift-by-one targets over ``[BOS] conditions sequence``
rows padded to ``block_size`` (``protein/data.py``), AdamW at optax's
semantics with the learning rate set once an epoch to
``lr * 0.5 * (1 + cos(pi * epoch / epochs))`` (JAX's ``inject_hyperparams``),
gradient accumulation whose last group divides by its own size, wall-time
checkpoints at microbatch boundaries, ``epoch_NNN.npz`` and ``last.npz``
(the model in the JAX tree layout under ``model_state_dict``), resume from
the port's own ``last.npz`` (a JAX checkpoint's optax state cannot be read).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.models.protein import ProteinLMConfig, protein_lm_forward
from genomics_lm_torch.ops.losses import cross_entropy
from genomics_lm_torch.protein import common
from genomics_lm_torch.protein.data import encode_dataset
from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
from genomics_lm_torch.training import checkpoints as ckpt_lib
from genomics_lm_torch.training.lifecycle import (
    TrainingRun,
    capture_rng_state,
    configuration_fingerprint,
    restore_rng_state,
)
from genomics_lm_torch.training.runtime import WallTimer


def lm_config(config: dict, vocab_size: int) -> ProteinLMConfig:
    model_cfg_map = config.get("model", {})
    return ProteinLMConfig(
        vocab_size=vocab_size,
        n_layer=int(model_cfg_map.get("n_layer", 4)),
        n_head=int(model_cfg_map.get("n_head", 4)),
        n_embd=int(model_cfg_map.get("n_embd", 256)),
        block_size=int(model_cfg_map.get("block_size", 512)),
        dropout=float(model_cfg_map.get("dropout", 0.1)),
    )


def train(
    config: dict,
    *,
    resume: str | None = None,
    run_id: str | None = None,
    run_root: str | Path = "runs/protein_lm",
    device: str | torch.device | None = None,
    init_tree: dict | None = None,
) -> dict:
    """Train from a config dict with ``model:``, ``training:``, ``data:``;
    ``init_tree`` (a JAX tree) replaces the fresh draw."""
    device = common.resolve_device(device)
    training_cfg = config.get("training", {})
    data_cfg = config.get("data", {})
    tokenizer = ProteinTokenizer()
    cfg = lm_config(config, len(tokenizer))
    epochs = int(training_cfg["epochs"])
    batch_size = int(training_cfg["batch_size"])
    grad_accum = int(training_cfg.get("grad_accum_steps", 1))
    seed = int(training_cfg.get("seed", 1337))

    fingerprint = configuration_fingerprint(config)
    requested = run_id or config.get("run_id") or "protein_lm"
    training_run = TrainingRun.open(
        run_root, requested, resume=resume,
        target_epochs=epochs, config_fingerprint=fingerprint,
    )

    train_data = encode_dataset(data_cfg["train_path"], tokenizer, cfg.block_size)
    val_data = encode_dataset(data_cfg["val_path"], tokenizer, cfg.block_size)

    model = common.start_model("lm", cfg, device, seed=seed, init_tree=init_tree)
    generator = torch.Generator(device=device).manual_seed(seed)
    base_lr = float(training_cfg["lr"])
    weight_decay = float(training_cfg.get("weight_decay", 0.01))

    def schedule(ep):  # per-epoch cosine annealing (torch CosineAnnealingLR(T_max=epochs))
        return base_lr * 0.5 * (1 + math.cos(math.pi * min(ep, epochs) / epochs))

    optimizer = common.adamw(model, base_lr, weight_decay)
    pad = tokenizer.pad_token_id

    def loss_of(batch, train_mode):
        logits = protein_lm_forward(model, cfg, batch[:, :-1], train=train_mode,
                                    generator=generator if train_mode else None)
        return cross_entropy(logits, batch[:, 1:], ignore_index=pad)

    optimizer_step = 0
    start_epoch = 0
    current_microbatch = 0
    if resume:
        payload = ckpt_lib.load_checkpoint(resume)
        model = common.start_model("lm", cfg, device, seed=seed,
                                   init_tree=payload["model_state_dict"])
        optimizer = common.adamw(model, base_lr, weight_decay)
        common.load_optimizer_state(optimizer, model, payload["optimizer_state_dict"])
        restore_rng_state(payload.get("rng_state"), generator)
        optimizer_step = int(payload.get("optimizer_step", 0))
        start_epoch = int(payload["epoch"]) + (1 if payload.get("epoch_complete", True) else 0)

    wall_timer = WallTimer(training_cfg.get("max_time_minutes"))

    def save_ckpt(path, epoch, loss, reason):
        complete = reason == "epoch"
        ckpt_lib.save_checkpoint(
            {
                "epoch": epoch,
                "epoch_complete": complete,
                "microbatch_idx": 0 if complete else current_microbatch,
                "model_state_dict": common.protein_params_to_jax(model),
                "optimizer_state_dict": common.optimizer_state(optimizer, model),
                "loss": float(loss),
                "optimizer_step": optimizer_step,
                "checkpoint_reason": reason,
                "cfg": common.checkpoint_cfg(config),
                "run_fingerprint": fingerprint,
                "rng_state": capture_rng_state(generator),
                "run_progress": {
                    "completed_epochs": epoch + 1 if complete else epoch,
                    "current_epoch": epoch + 1,
                    "microbatch": 0 if complete else current_microbatch,
                    "optimizer_step": optimizer_step,
                },
            },
            path,
        )

    history = []
    for epoch in range(start_epoch, epochs):
        model.train()
        order = np.random.default_rng(seed + epoch).permutation(len(train_data))
        n_acc = 0
        for group in optimizer.param_groups:
            group["lr"] = schedule(epoch)
        n_batches = math.ceil(len(order) / batch_size)
        optimizer.zero_grad(set_to_none=True)
        for index in range(n_batches):
            rows = order[index * batch_size : (index + 1) * batch_size]
            current_microbatch = index + 1
            loss = loss_of(torch.as_tensor(train_data[rows], device=device), True)
            loss.backward()
            n_acc += 1
            if (index + 1) % grad_accum == 0 or index + 1 == n_batches:
                common.apply_accumulated(optimizer, n_acc)
                n_acc = 0
                optimizer_step += 1
            if index % 100 == 0:
                print(f"Epoch {epoch + 1}/{epochs}, Step {index}, Loss: {float(loss.detach()):.4f}")
            if wall_timer.expired():
                save_ckpt(training_run.checkpoints / "last.npz", epoch, float("inf"), "wall_time")
                training_run.close()
                return {"status": "stopped", "epoch": epoch}

        model.eval()
        with torch.no_grad():
            val_losses = [
                float(loss_of(torch.as_tensor(val_data[i : i + batch_size], device=device),
                              False))
                for i in range(0, len(val_data), batch_size)
            ]
        val_loss = float(np.mean(val_losses)) if val_losses else float("inf")
        print(f"Epoch {epoch + 1}, Val Loss: {val_loss:.4f}")
        history.append({"epoch": epoch + 1, "val_loss": val_loss})
        save_ckpt(training_run.checkpoints / f"epoch_{epoch + 1:03d}.npz", epoch, val_loss, "epoch")
        save_ckpt(training_run.checkpoints / "last.npz", epoch, val_loss, "epoch")

    (training_run.scores / "metrics.json").write_text(json.dumps(history, indent=2))
    training_run.mark_complete({"completed_epochs": epochs})
    training_run.close()
    return {"status": "completed", "history": history}


__all__ = ["lm_config", "train"]
