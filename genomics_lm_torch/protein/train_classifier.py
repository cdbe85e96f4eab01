"""Single-task protein classifier trainer, BOS-representation head (twin of
``genomics_lm_tpu/protein/train_classifier.py``).

A bidirectional backbone, cross-entropy over the valid (label >= 0) rows of
one label key, one AdamW step (optax semantics) per length-bucketed batch,
validation accuracy each epoch, ``last.npz`` and ``best.npz`` (the model in
the JAX tree layout) and ``metrics.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from genomics_lm_torch.models.protein import ProteinClassifierConfig, classifier_forward
from genomics_lm_torch.ops.losses import cross_entropy
from genomics_lm_torch.protein import common
from genomics_lm_torch.protein.dataset import (
    MultiTaskProteinDataset,
    length_bucket_batches,
    pad_width_for,
)
from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
from genomics_lm_torch.training import checkpoints as ckpt_lib
from genomics_lm_torch.training.lifecycle import TrainingRun, configuration_fingerprint


def train(
    cfg: dict,
    *,
    label_key: str = "function",
    run_root: str | Path = "runs/protein_classifier",
    resume: str | None = None,
    device: str | torch.device | None = None,
    init_tree: dict | None = None,
) -> dict:
    device = common.resolve_device(device)
    tokenizer = ProteinTokenizer()
    block_size = int(cfg.get("block_size", 512))
    train_ds = MultiTaskProteinDataset(cfg["train_data"], tokenizer, max_length=block_size)
    val_ds = MultiTaskProteinDataset(cfg["val_data"], tokenizer, max_length=block_size)

    labels = [int(s.get({"family": "pfam_id", "function": "ec_id",
                         "stability": "stability_id"}.get(label_key, label_key), -1))
              for s in train_ds.samples]
    num_classes = int(cfg.get("num_classes") or (max(labels) + 1 if labels else 2))

    model_cfg = ProteinClassifierConfig(
        vocab_size=len(tokenizer),
        n_layer=int(cfg.get("n_layer", 4)),
        n_head=int(cfg.get("n_head", 4)),
        n_embd=int(cfg.get("n_embd", 256)),
        block_size=block_size,
        dropout=float(cfg.get("dropout", 0.1)),
        num_classes=num_classes,
    )
    seed = int(cfg.get("seed", 1337))
    epochs = int(cfg["epochs"])
    batch_size = int(cfg.get("batch_size", 8))

    training_run = TrainingRun.open(
        run_root, cfg.get("run_id") or "protein_classifier",
        resume=resume, target_epochs=epochs,
        config_fingerprint=configuration_fingerprint(cfg),
    )

    model = common.start_model("classifier", model_cfg, device, seed=seed, init_tree=init_tree)
    generator = torch.Generator(device=device).manual_seed(seed)
    optimizer = common.adamw(model, float(cfg.get("lr", 1e-4)),
                             float(cfg.get("weight_decay", 0.01)))

    def tensors(batch):
        return (torch.as_tensor(batch["input_ids"], device=device),
                torch.as_tensor(batch["attention_mask"], device=device))

    best_acc = -1.0
    history = []
    loss = torch.zeros(())
    for epoch in range(1, epochs + 1):
        model.train()
        for rows in length_bucket_batches(train_ds, batch_size, seed=seed, epoch=epoch):
            width = pad_width_for([train_ds.sequence_length(r) for r in rows])
            batch = train_ds.batch(rows, pad_to=width)
            y = torch.as_tensor(batch[label_key], device=device)
            valid = y >= 0
            logits = classifier_forward(model, model_cfg, *tensors(batch), train=True,
                                        generator=generator)
            loss = cross_entropy(logits, torch.where(valid, y, torch.zeros_like(y)),
                                 ignore_index=None, valid_mask=valid)
            loss.backward()
            common.apply_accumulated(optimizer)
        model.eval()
        correct = total = 0
        with torch.no_grad():
            for rows in length_bucket_batches(val_ds, batch_size, shuffle=False, seed=seed,
                                              epoch=0):
                width = pad_width_for([val_ds.sequence_length(r) for r in rows])
                batch = val_ds.batch(rows, pad_to=width)
                y = batch[label_key]
                preds = classifier_forward(model, model_cfg, *tensors(batch)).argmax(-1)
                preds = preds.cpu().numpy()
                valid = y >= 0
                correct += int((preds[valid] == y[valid]).sum())
                total += int(valid.sum())
        acc = correct / max(total, 1)
        print(f"[classifier] epoch {epoch} loss {float(loss.detach()):.4f} val_acc {acc:.4f}")
        history.append({"epoch": epoch, "val_acc": acc})
        payload = {
            "model": common.protein_params_to_jax(model),
            "epoch": epoch,
            "val_acc": acc,
            "num_classes": num_classes,
            "label_key": label_key,
            "run_progress": {"completed_epochs": epoch, "current_epoch": epoch,
                             "microbatch": 0, "optimizer_step": epoch},
        }
        ckpt_lib.save_checkpoint(payload, training_run.checkpoints / "last.npz")
        if acc > best_acc:
            best_acc = acc
            ckpt_lib.save_checkpoint(payload, training_run.checkpoints / "best.npz")

    meta = {"status": "completed", "best_val_acc": best_acc, "history": history}
    (training_run.scores / "metrics.json").write_text(json.dumps(meta, indent=2))
    training_run.mark_complete({"completed_epochs": epochs})
    training_run.close()
    return meta


__all__ = ["train"]
