"""Flagship d512 quality benchmark with paired-bootstrap margins (twin of
``scripts/benchmark_flagship_quality.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.evals.benchmark_flagship_quality \\
        [--out outputs/flagship_d512/flagship_d512_quality_cuda.json] \\
        [--workdir outputs/flagship_d512] [--genes 20000] [--epochs 20] [--device cpu]

1. The dataset: the demo corpus (``data/demo_corpus.py``, ``--genes`` genes
   from ``--seed``) prepared at ``--block_size`` through
   ``data/pipeline.py::prepare_dataset`` (packed by genome, the native
   audit, no homology pass); rebuilt only when ``<workdir>/dataset`` lacks
   the train split.
2. The run: 12L8H d512 (``--n_layer``/``--n_head``/``--n_embd``) with the
   script's ``train_cfg``: bf16, ``attention_impl="flash"`` (the port's
   flash kernels on the card), fused QKV, tied embeddings, no label
   smoothing (so the NLL compares with the count baselines), AdamW under a
   cosine schedule; ``training/loop.py::run_training`` writes
   ``<workdir>/runs/flagship-d512``, and a completed run is reused.
3. The report: the best checkpoint's NLL on the val and test splits, the
   Markov baselines fitted on the train split (the trigram history reset at
   ``<SEP>``), every model-against-baseline margin with its paired-bootstrap
   95% interval over packed rows (``evals/significance.py``), the hardest
   non-uniform baseline, whether the model beats it with an interval that
   excludes zero, and the test context ablation (windows 1, 2, 4, full).

The report has the script's keys; the exit code is 0 if and only if the test
margin over the hardest baseline is positive with its interval above zero.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np


def build_dataset(workdir: Path, *, genes: int, block_size: int, seed: int) -> Path:
    from genomics_lm_torch.data.demo_corpus import main as make_corpus
    from genomics_lm_torch.data.pipeline import prepare_dataset

    dataset_dir = workdir / "dataset"
    if (dataset_dir / f"train_bs{block_size}.npz").exists():
        print(f"[dataset] reusing {dataset_dir}")
        return dataset_dir
    records_tsv = workdir / "records.tsv"
    workdir.mkdir(parents=True, exist_ok=True)
    make_corpus(["--out", str(records_tsv), "--genes", str(genes), "--seed", str(seed)])
    with records_tsv.open() as f:
        records = [dict(r) for r in csv.DictReader(f, delimiter="\t")]
    prepare_dataset(records, dataset_dir, block_size=block_size, pack_mode="multi",
                    group_by="genome", split_seed=seed, skip_homology=True,
                    audit_engine="native")
    return dataset_dir


def train_cfg(args, dataset_dir: Path) -> dict:
    block = args.block_size
    return {
        "train_npz": str(dataset_dir / f"train_bs{block}.npz"),
        "val_npz": str(dataset_dir / f"val_bs{block}.npz"),
        "block_size": block,
        "vocab_size": 68,
        "n_layer": args.n_layer,
        "n_head": args.n_head,
        "n_embd": args.n_embd,
        "dropout": args.dropout,
        "label_smoothing": 0.0,  # NLL comparable to the count baselines
        "tie_embeddings": True,
        # the production path: bench.py's throughput configuration
        "compute_dtype": "bfloat16",
        "attention_impl": "flash",
        "fused_qkv": True,
        "flash_block_q": 512,
        "flash_block_k": 512,
        "batch_size": args.batch_size,
        "grad_accum_steps": args.grad_accum,
        "lr": args.lr,
        "min_lr": args.lr / 10.0,
        "weight_decay": 0.05,
        "warmup_steps": args.warmup_steps,
        "optimizer": "adamw",
        "scheduler": "cosine",
        "epochs": args.epochs,
        "seed": args.seed,
        "dataloader_seed": args.seed,
        "early_stop_patience": 0,
        "itos_path": str(dataset_dir / "itos.txt"),
        "run_id": "flagship-d512",
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/flagship_d512/flagship_d512_quality_cuda.json")
    ap.add_argument("--workdir", default="outputs/flagship_d512")
    ap.add_argument("--genes", type=int, default=20000)
    ap.add_argument("--block_size", type=int, default=512)
    ap.add_argument("--n_layer", type=int, default=12)
    ap.add_argument("--n_head", type=int, default=8)
    ap.add_argument("--n_embd", type=int, default=512)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup_steps", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--bootstrap", type=int, default=2000)
    ap.add_argument("--bootstrap_seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from genomics_lm_torch.evals.markov import (
        evaluate_baselines,
        fit_baselines,
        per_row_baseline_nll,
    )
    from genomics_lm_torch.evals.perplexity import (
        context_ablation,
        evaluate_perplexity,
        per_row_model_nll,
    )
    from genomics_lm_torch.evals.significance import paired_bootstrap_margins
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.tokenizers.codon import SEP_ID
    from genomics_lm_torch.training.checkpoints import load_checkpoint
    from genomics_lm_torch.training.loop import run_training
    from genomics_lm_torch.utils.device import resolve_device
    from genomics_lm_torch.utils.weights import params_from_jax

    device = resolve_device(args.device)
    workdir = Path(args.workdir)
    dataset_dir = build_dataset(workdir, genes=args.genes, block_size=args.block_size,
                                seed=args.seed)
    block = args.block_size

    cfg = train_cfg(args, dataset_dir)
    run_dir = workdir / "runs" / cfg["run_id"]
    if (run_dir / "run_complete.json").exists():
        print(f"[train] reusing completed run {run_dir}")
        train_meta = json.loads((run_dir / "checkpoints" / "meta.json").read_text())
    else:
        train_meta = run_training(cfg, run_root=workdir / "runs", device=device)
    if train_meta.get("train_wall_sec") and train_meta.get("consumed_train_tokens"):
        print(f"[train] {train_meta['consumed_train_tokens']} non-pad tokens in "
              f"{train_meta['train_wall_sec']} s: "
              f"{train_meta['consumed_train_tokens'] / train_meta['train_wall_sec']:.1f} "
              "tokens/s (validation included)", flush=True)

    model_cfg = CodonGPTConfig.from_run_config(cfg).replace(dropout=0.0)
    payload = load_checkpoint(run_dir / "checkpoints" / "best.npz", keys=("model",))
    model = params_from_jax(payload["model"], model_cfg, device)

    def split(name):
        return dataset_dir / f"{name}_bs{block}.npz"

    def xy(name):
        with np.load(split(name)) as z:
            return z["X"], z["Y"]

    reset_ids = frozenset({SEP_ID})
    counts = fit_baselines(*xy("train"), 68, args.alpha, reset_token_ids=reset_ids)

    report = {
        "protocol": {
            "corpus": f"make_demo_corpus genes={args.genes} seed={args.seed} "
                      "(4 genera x 3 genomes, coupling 0.55)",
            "model": f"{args.n_layer}L{args.n_head}H d{args.n_embd} "
                     f"block{block}, dropout {args.dropout}, "
                     "bf16 + the port's flash kernels + fused QKV",
            "budget": f"epochs={args.epochs} b{args.batch_size}x"
                      f"{args.grad_accum} lr={args.lr} cosine "
                      f"warmup={args.warmup_steps}",
            "checkpoint": "best (lowest val loss)",
            "margins": "paired bootstrap over packed rows; margin = "
                       "baseline - model corpus NLL (nats/token, "
                       "positive = model better); 95% percentile CI",
            "reference_analog": "the reference's docs/PERPLEXITY_BASELINES.md:46-63 "
                                "(3.2M-token frozen-split protocol)",
        },
        "train": {
            "n_params": train_meta.get("n_params"),
            "best_val_loss": train_meta.get("best_val_loss"),
            "train_wall_sec": train_meta.get("train_wall_sec"),
        },
    }

    for name in ("val", "test"):
        x, y = xy(name)
        model_eval = evaluate_perplexity(model, model_cfg, split(name))
        baselines, tokens, best_name = evaluate_baselines(
            x, y, counts, 68, args.alpha, reset_token_ids=reset_ids)
        model_rows, tokens_rows = per_row_model_nll(model, model_cfg, split(name))
        base_rows, base_tokens = per_row_baseline_nll(
            x, y, counts, 68, args.alpha, reset_token_ids=reset_ids)
        if not np.array_equal(tokens_rows, base_tokens):
            raise RuntimeError(f"{name}: per-row token pairing mismatch")
        margins = paired_bootstrap_margins(model_rows, tokens_rows, base_rows,
                                           n_boot=args.bootstrap, seed=args.bootstrap_seed)
        # the promotion question: does the CI on the margin over the best
        # count baseline exclude zero?
        non_uniform = {n: m for n, m in margins.items() if n != "Uniform"}
        hardest = min(non_uniform, key=lambda n: baselines[n]["cross_entropy_nats"])
        report[name] = {
            "model": model_eval,
            "baselines": baselines,
            "tokens": tokens,
            "best_simple_model": best_name,
            "margins": margins,
            "hardest_baseline": hardest,
            "beats_hardest_with_ci": bool(margins[hardest]["margin_nats"] > 0
                                          and margins[hardest]["excludes_zero"]),
        }
        print(f"[{name}] model nll {model_eval['nll']:.4f} | hardest {hardest} "
              f"margin {margins[hardest]['margin_nats']:+.4f} "
              f"[{margins[hardest]['ci_low']:+.4f}, {margins[hardest]['ci_high']:+.4f}]",
              flush=True)

    report["context_ablation"] = context_ablation(model, model_cfg, split("test"))
    report["config"] = {k: v for k, v in cfg.items()
                        if not k.endswith("_npz") and k != "itos_path"}

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(f"[flagship-quality] wrote {out}")
    ok = report["test"]["beats_hardest_with_ci"]
    print(f"[flagship-quality] test margin CI excludes zero: {ok}")
    return 0 if ok else 1


__all__ = ["build_dataset", "main", "parser", "train_cfg"]


if __name__ == "__main__":
    raise SystemExit(main())
