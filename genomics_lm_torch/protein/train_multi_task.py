"""Multi-task protein-critic trainer (twin of
``genomics_lm_tpu/protein/train_multi_task.py``; the CLI is
``scripts/train_multi_task.py``'s, plus ``--device``):

    python -m genomics_lm_torch.protein.train_multi_task --config critic.yaml \
        [--run_root runs/protein_critic] [--resume .../last_critic.npz] \
        [--transfer_from ckpt.npz] [--device cpu]

- sha256 binding of the data (``dataset_sha256``), head widths from the
  config's ``task_dims`` or the labels seen,
- sqrt-inverse-frequency class weights (train split only, clamped) in
  training only: validation stays unweighted,
- multi-label BCE with automatic ``pos_weight``, stability as NaN-masked
  smooth-L1 regression or classification, the opt-in saliency term,
- length-bucketed batches padded to power-of-two widths, gradient
  accumulation whose last group divides by its own size,
- AdamW at optax's semantics, dropout from a ``torch.Generator``,
- wall-time checkpoints at group boundaries, ``best_critic.npz`` /
  ``last_critic.npz`` (the model in the JAX tree layout, so JAX's
  ``load_checkpoint`` + ``multitask_forward`` and ``critic_scoring.load_score_fn``
  read it), ``curves.csv`` and ``metrics.json`` with JAX's keys.

Resume departs from JAX on purpose: JAX's trainer validates the run and then
starts again from a fresh init at epoch 1, appending duplicate curve rows;
this one restores the model, AdamW, the generator, the best loss and the
step count from ``last_critic.npz`` and continues after its last completed
epoch (``ROADMAP.md`` §3). A JAX checkpoint's optax state cannot be resumed
(``--transfer_from`` takes its weights). Each epoch also prints its seconds,
sequences/s and the device's peak memory.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.models.protein import ProteinClassifierConfig, multitask_forward
from genomics_lm_torch.protein import common
from genomics_lm_torch.protein import losses as PL
from genomics_lm_torch.protein.dataset import (
    MultiTaskProteinDataset,
    length_bucket_batches,
    pad_width_for,
)
from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
from genomics_lm_torch.training import checkpoints as ckpt_lib
from genomics_lm_torch.training.lifecycle import (
    TrainingRun,
    capture_rng_state,
    checkpoint_progress,
    configuration_fingerprint,
    restore_rng_state,
)
from genomics_lm_torch.training.runtime import WallTimer


def bind_critic_dataset(path: str | Path, expected_sha256: str | None) -> str:
    """Fail-closed sha256 binding of a critic dataset file."""
    digest = hashlib.sha256(Path(path).read_bytes()).hexdigest()
    if expected_sha256 is not None and digest != expected_sha256:
        raise ValueError(
            f"critic dataset {path} sha256 {digest} != expected {expected_sha256}"
        )
    return digest


def infer_task_dims(dataset: MultiTaskProteinDataset, cfg: dict) -> dict[str, int]:
    """Head dims from config task vocabs or observed label maxima."""
    dims = dict(cfg.get("task_dims") or {})
    if "family" not in dims:
        dims["family"] = max(
            (int(s.get("pfam_id", -1)) for s in dataset.samples), default=-1
        ) + 1 or 2
    if "function" not in dims:
        dims["function"] = max(
            (int(s.get("ec_id", -1)) for s in dataset.samples), default=-1
        ) + 1 or 2
    if "stability" not in dims:
        is_reg = any("stability_score" in s for s in dataset.samples)
        dims["stability"] = 1 if is_reg else max(
            (int(s.get("stability_id", -1)) for s in dataset.samples), default=1
        ) + 1
    return {k: max(int(v), 1) for k, v in dims.items()}


def critic_config(cfg: dict, vocab_size: int) -> ProteinClassifierConfig:
    return ProteinClassifierConfig(
        vocab_size=vocab_size,
        n_layer=int(cfg.get("n_layer", 4)),
        n_head=int(cfg.get("n_head", 4)),
        n_embd=int(cfg.get("n_embd", 256)),
        block_size=int(cfg.get("block_size", 512)),
        dropout=float(cfg.get("dropout", 0.1)),
        num_classes=2,
        pooling=str(cfg.get("pooling", "mean")),
        bidirectional=bool(cfg.get("bidirectional", True)),
    )


@dataclass
class CriticObjective:
    """The critic's weighted sum of task losses (JAX's ``batch_losses``):
    class-weighted CE for family and function (the weights in training only,
    so validation is unweighted), smooth-L1 or CE for stability, BCE with
    ``pos_weight`` for each multi-label task, and the saliency term."""

    model_cfg: ProteinClassifierConfig
    stability_regression: bool
    multi_label_tasks: list = field(default_factory=list)
    class_weights: dict = field(default_factory=dict)
    pos_weights: dict = field(default_factory=dict)
    task_loss_weights: dict = field(default_factory=dict)
    saliency_weight: float = 0.0

    @property
    def use_saliency(self) -> bool:
        return self.saliency_weight > 0.0 and self.model_cfg.pooling == "attention"

    def __call__(self, model, batch: dict, train_mode: bool, generator=None):
        out = multitask_forward(model, self.model_cfg, batch["input_ids"],
                                batch["attention_mask"], train=train_mode, generator=generator)
        weight = lambda task: float(self.task_loss_weights.get(task, 1.0))  # noqa: E731
        losses = {}
        total = torch.zeros((), device=batch["input_ids"].device)
        if self.use_saliency and "motif_mask" in batch and "attention_weights" in out:
            sal = PL.saliency_regularizer(out["attention_weights"], batch["motif_mask"])
            losses["saliency"] = sal
            total = total + self.saliency_weight * sal
        for task in ("family", "function"):
            if task in out:
                loss, _ = PL.classification_loss(
                    out[task], batch[task],
                    self.class_weights.get(task) if train_mode else None,
                )
                losses[task] = loss
                total = total + weight(task) * loss
        if "stability" in out:
            if self.stability_regression:
                loss, _ = PL.smooth_l1_nan_masked(out["stability"][:, 0], batch["stability"])
            else:
                loss, _ = PL.classification_loss(out["stability"], batch["stability"])
            losses["stability"] = loss
            total = total + weight("stability") * loss
        for task in self.multi_label_tasks:
            if task in out and task in batch:
                loss = PL.multilabel_bce_loss(out[task], batch[task], self.pos_weights.get(task))
                losses[task] = loss
                total = total + weight(task) * loss
        return total, losses


def critic_objective(cfg: dict, train_ds: MultiTaskProteinDataset, task_dims: dict,
                     model_cfg: ProteinClassifierConfig, device) -> CriticObjective:
    """The objective of a run config: sqrt-inverse-frequency class weights
    and ``pos_weight`` from the train split only."""
    multi_label_tasks = list(cfg.get("multi_label_tasks") or [])
    weighting_mode = str(
        cfg.get("classification_class_weighting", "sqrt_inverse_frequency"))
    weight_max = float(cfg.get("classification_class_weight_max", 4.0))
    class_weights = {}
    if weighting_mode != "none":
        for task, id_key in (("family", "pfam_id"), ("function", "ec_id")):
            if task in task_dims and task_dims[task] > 1:
                labels = np.asarray([s.get(id_key, -1) for s in train_ds.samples])
                if (labels >= 0).any():
                    class_weights[task] = torch.as_tensor(
                        PL.sqrt_inverse_frequency_weights(
                            labels, task_dims[task], clamp_max=weight_max), device=device)
    pos_weights = {}
    for task in multi_label_tasks:
        mats = [
            np.asarray(s.get(task) or s.get(f"{task}_labels") or [], np.float32)
            for s in train_ds.samples
        ]
        width = max((m.size for m in mats), default=0)
        if width:
            stacked = np.zeros((len(mats), width), np.float32)
            for i, m in enumerate(mats):
                stacked[i, : m.size] = m
            pos_weights[task] = torch.as_tensor(PL.auto_pos_weight(stacked), device=device)
    return CriticObjective(
        model_cfg=model_cfg, stability_regression=task_dims.get("stability") == 1,
        multi_label_tasks=multi_label_tasks, class_weights=class_weights,
        pos_weights=pos_weights, task_loss_weights=dict(cfg.get("task_loss_weights") or {}),
        saliency_weight=float(cfg.get("saliency_regularizer_weight", 0.0)))


def train(
    cfg: dict,
    *,
    resume: str | None = None,
    transfer_from: str | None = None,
    run_root: str | Path = "runs/protein_critic",
    device: str | torch.device | None = None,
    init_tree: dict | None = None,
) -> dict:
    """Train the critic; ``init_tree`` (a JAX tree) replaces the fresh draw."""
    device = common.resolve_device(device)
    tokenizer = ProteinTokenizer()
    block_size = int(cfg.get("block_size", 512))
    multi_label_tasks = list(cfg.get("multi_label_tasks") or [])

    if cfg.get("dataset_sha256"):
        bind_critic_dataset(cfg["train_data"], cfg["dataset_sha256"].get("train"))
        bind_critic_dataset(cfg["val_data"], cfg["dataset_sha256"].get("val"))

    train_ds = MultiTaskProteinDataset(
        cfg["train_data"], tokenizer, max_length=block_size,
        multi_label_tasks=multi_label_tasks,
    )
    val_ds = MultiTaskProteinDataset(
        cfg["val_data"], tokenizer, max_length=block_size,
        multi_label_tasks=multi_label_tasks,
    )
    task_dims = infer_task_dims(train_ds, cfg)
    model_cfg = critic_config(cfg, len(tokenizer))
    objective = critic_objective(cfg, train_ds, task_dims, model_cfg, device)

    fingerprint = configuration_fingerprint(cfg)
    run_id = cfg.get("run_id") or "protein_critic"
    training_run = TrainingRun.open(
        run_root, run_id, resume=resume,
        last_checkpoint_name="last_critic.npz",
        target_epochs=int(cfg["epochs"]), config_fingerprint=fingerprint,
    )

    seed = int(cfg.get("seed", 1337))
    model = common.start_model("multitask", model_cfg, device, seed=seed,
                               task_dims=task_dims, init_tree=init_tree)
    generator = torch.Generator(device=device).manual_seed(seed)

    if transfer_from is not None:
        source = ckpt_lib.load_checkpoint(transfer_from)
        tree, report = ckpt_lib.transfer_load_params(
            common.protein_params_to_jax(model), source.get("model", source))
        model = common.start_model("multitask", model_cfg, device, seed=seed, init_tree=tree)
        print(
            f"[transfer] loaded={len(report['loaded'])} skipped={len(report['skipped'])} "
            f"missing={len(report['missing'])}"
        )

    lr = float(cfg.get("lr", 1e-4))
    optimizer = common.adamw(model, lr, float(cfg.get("weight_decay", 0.01)))
    grad_accum = int(cfg.get("grad_accum_steps", 1))

    def batch_losses(batch, train_mode):
        return objective(model, batch, train_mode, generator if train_mode else None)

    def to_device(batch):
        device_batch = common.batch_to_device(batch, device)
        if objective.use_saliency:
            device_batch["motif_mask"] = torch.as_tensor(PL.motif_position_mask(
                batch["sequence"], batch["input_ids"].shape[1]), device=device)
        return device_batch

    wall_timer = WallTimer(cfg.get("max_time_minutes"))
    epochs = int(cfg["epochs"])
    batch_size = int(cfg.get("batch_size", 8))
    best = float("inf")
    best_epoch = -1
    optimizer_step = 0
    start_epoch = 1
    history = []
    if resume:
        payload = ckpt_lib.load_checkpoint(resume)
        model = common.start_model("multitask", model_cfg, device, seed=seed,
                                   init_tree=payload["model"])
        optimizer = common.adamw(model, lr, float(cfg.get("weight_decay", 0.01)))
        common.load_optimizer_state(optimizer, model, payload.get("optimizer"))
        restore_rng_state(payload.get("rng_state"), generator)
        best = float(payload.get("best_val", float("inf")))
        best_epoch = int(payload.get("best_epoch", -1))
        optimizer_step = int(payload.get("optimizer_step", 0))
        start_epoch = checkpoint_progress(payload).completed_epochs + 1
    curves = training_run.scores / "curves.csv"
    if not curves.exists():
        curves.write_text("epoch,train_loss,val_loss\n")

    def save_ckpt(name, epoch, val_loss, reason="epoch"):
        ckpt_lib.save_checkpoint(
            {
                "model": common.protein_params_to_jax(model),
                "optimizer": common.optimizer_state(optimizer, model),
                "cfg": common.checkpoint_cfg(cfg),
                "task_dims": task_dims,
                "epoch": epoch,
                "val_loss": float(val_loss),
                "best_val": float(best),
                "best_epoch": best_epoch,
                "optimizer_step": optimizer_step,
                "checkpoint_reason": reason,
                "run_fingerprint": fingerprint,
                "rng_state": capture_rng_state(generator),
                "run_progress": {
                    "completed_epochs": epoch if reason == "epoch" else epoch - 1,
                    "current_epoch": epoch,
                    "microbatch": 0,
                    "optimizer_step": optimizer_step,
                },
            },
            training_run.checkpoints / name,
        )

    status = "completed"
    try:
        for epoch in range(start_epoch, epochs + 1):
            model.train()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            seqs = residues = 0
            train_sum, n_mb = torch.zeros((), device=device), 0
            n_acc = 0
            batches = list(
                length_bucket_batches(train_ds, batch_size, seed=seed, epoch=epoch)
            )
            optimizer.zero_grad(set_to_none=True)
            for bi, rows in enumerate(batches):
                width = pad_width_for([train_ds.sequence_length(r) for r in rows])
                host = train_ds.batch(rows, pad_to=width)
                total, _ = batch_losses(to_device(host), True)
                total.backward()
                n_acc += 1
                train_sum = train_sum + total.detach()
                n_mb += 1
                seqs += len(rows)
                residues += int(host["attention_mask"].sum())
                if (bi + 1) % grad_accum == 0 or bi + 1 == len(batches):
                    common.apply_accumulated(optimizer, n_acc)
                    n_acc = 0
                    optimizer_step += 1
                if bi % 50 == 0:
                    dt = max(time.perf_counter() - t0, 1e-9)
                    print(
                        f"[critic] epoch {epoch} batch {bi}/{len(batches)} "
                        f"loss={float(total.detach()):.4f} {seqs / dt:.2f} seq/s "
                        f"{residues / dt:.0f} res/s"
                    )
                if wall_timer.expired():
                    save_ckpt("last_critic.npz", epoch, float("inf"), reason="wall_time")
                    training_run.close()
                    return {"status": "stopped", "epoch": epoch}
            train_loss = float(train_sum) / max(n_mb, 1)
            train_seconds = time.perf_counter() - t0

            model.eval()
            val_sum, val_n = 0.0, 0
            with torch.no_grad():
                for rows in length_bucket_batches(
                    val_ds, batch_size, shuffle=False, seed=seed, epoch=0
                ):
                    width = pad_width_for([val_ds.sequence_length(r) for r in rows])
                    total, _ = batch_losses(to_device(val_ds.batch(rows, pad_to=width)), False)
                    val_sum += float(total)
                    val_n += 1
            val_loss = val_sum / max(val_n, 1)
            print(f"[critic] epoch {epoch} train {train_loss:.4f} val {val_loss:.4f}")
            peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None)
            print(f"[critic] epoch {epoch} seconds {train_seconds:.2f} "
                  f"{seqs / max(train_seconds, 1e-9):.2f} seq/s "
                  f"{residues / max(train_seconds, 1e-9):.0f} res/s peak_memory_bytes {peak}")
            with curves.open("a") as f:
                f.write(f"{epoch},{train_loss:.4f},{val_loss:.4f}\n")
            history.append({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss})
            if val_loss < best:
                best = val_loss
                best_epoch = epoch
                save_ckpt("best_critic.npz", epoch, val_loss)
            save_ckpt("last_critic.npz", epoch, val_loss)
    except Exception:
        status = "failed"
        raise
    finally:
        meta = {
            "status": status,
            "best_epoch": best_epoch,
            "best_val_loss": best if best != float("inf") else None,
            "task_dims": task_dims,
            "history": history,
        }
        (training_run.scores / "metrics.json").write_text(json.dumps(meta, indent=2))
        if status == "completed":
            training_run.mark_complete({"completed_epochs": epochs, "best_epoch": best_epoch})
        training_run.close()
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the multi-task protein critic")
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--transfer_from", default=None)
    ap.add_argument("--run_root", default="runs/protein_critic")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}
    train(cfg, resume=args.resume, transfer_from=args.transfer_from,
          run_root=args.run_root, device=args.device)
    return 0


__all__ = ["CriticObjective", "bind_critic_dataset", "critic_config", "critic_objective",
           "infer_task_dims", "main", "train"]


if __name__ == "__main__":
    raise SystemExit(main())
