"""Protein-critic training-throughput benchmark (twin of
``scripts/benchmark_protein_critic_training.py``, the same flags plus
``--device``):

    python -m genomics_lm_torch.protein.benchmark_protein_critic_training \
        --jsonl train.jsonl [--batch_sizes 4,8,16] [--n_layer 4 --n_head 4 \
        --n_embd 256] [--block_size 512] [--sample 64] [--measure_steps 5] \
        [--out outputs/benchmarks/critic_training.json] [--device cpu]

A deterministic length-stratified sample of the split, padded to
``block_size``; for each batch size one warm-up step, then
``--measure_steps`` AdamW steps (optax's defaults: decay 1e-4) of the
attention-pooled critic's summed per-task CE on seeded random labels,
timed between two device synchronizations. Prints and writes one JSON list
of ``sec_per_step``, ``sequences_per_sec`` and ``tokens_per_sec`` per batch
size: on the card, the critic's training throughput.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def stratified_indices(dataset, count: int) -> list[int]:
    """Deterministic length-stratified sample including both endpoints."""
    count = min(int(count), len(dataset))
    ordered = sorted(range(len(dataset)), key=dataset.sequence_length)
    if count <= 1:
        return ordered[:1]
    step = (len(ordered) - 1) / (count - 1)
    return [ordered[round(i * step)] for i in range(count)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", required=True, help="multitask JSONL split")
    ap.add_argument("--batch_sizes", default="4,8,16")
    ap.add_argument("--n_layer", type=int, default=4)
    ap.add_argument("--n_head", type=int, default=4)
    ap.add_argument("--n_embd", type=int, default=256)
    ap.add_argument("--block_size", type=int, default=512)
    ap.add_argument("--sample", type=int, default=64)
    ap.add_argument("--measure_steps", type=int, default=5)
    ap.add_argument("--out", default="outputs/benchmarks/critic_training.json")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from genomics_lm_torch.models.protein import ProteinClassifierConfig, multitask_forward
    from genomics_lm_torch.protein import common
    from genomics_lm_torch.protein.dataset import MultiTaskProteinDataset
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer

    device = common.resolve_device(args.device)
    tokenizer = ProteinTokenizer()
    cfg = ProteinClassifierConfig(
        vocab_size=len(tokenizer), n_layer=args.n_layer, n_head=args.n_head,
        n_embd=args.n_embd, block_size=args.block_size, dropout=0.1,
        pooling="attention",
    )
    ds = MultiTaskProteinDataset(args.jsonl, tokenizer, max_length=cfg.block_size)
    sample = stratified_indices(ds, args.sample)
    task_dims = {"family": 4, "function": 8, "stability": 2}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def loss_fn(model, input_ids, attention_mask, labels):
        out = multitask_forward(model, cfg, input_ids, attention_mask)
        loss = torch.zeros((), device=device)
        for task in task_dims:
            lab = labels[task]
            valid = lab >= 0
            logp = torch.log_softmax(out[task], -1)
            picked = torch.gather(logp, 1, torch.clamp_min(lab, 0).long()[:, None])[:, 0]
            loss = loss - (picked * valid).sum() / torch.clamp_min(valid.sum(), 1)
        return loss

    results = []
    for bs in (int(b) for b in args.batch_sizes.split(",")):
        # every batch size starts from the same init and optimizer state
        model = common.start_model("multitask", cfg, device, seed=0, task_dims=task_dims)
        optimizer = common.adamw(model, 1e-4, 1e-4)
        rows = sample[:bs] if len(sample) >= bs else (sample * bs)[:bs]
        batch = ds.batch(rows, pad_to=cfg.block_size)
        input_ids = torch.as_tensor(batch["input_ids"], device=device)
        attention_mask = torch.as_tensor(batch["attention_mask"], device=device)
        labels = {t: torch.as_tensor(np.random.default_rng(0).integers(
            0, task_dims[t], bs).astype(np.int32), device=device) for t in task_dims}

        def step():
            loss = loss_fn(model, input_ids, attention_mask, labels)
            loss.backward()
            common.apply_accumulated(optimizer)
            return loss

        step()  # warm-up
        sync()
        t0 = time.time()
        for _ in range(args.measure_steps):
            step()
        sync()
        dt = (time.time() - t0) / args.measure_steps
        results.append({
            "batch_size": bs,
            "sec_per_step": round(dt, 4),
            "sequences_per_sec": round(bs / dt, 2),
            "tokens_per_sec": round(bs * cfg.block_size / dt, 1),
        })

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
