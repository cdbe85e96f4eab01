"""MoE-vs-dense benchmark: quality at a matched step budget, and training
throughput at the flagship width (twin of ``scripts/benchmark_moe.py``'s
quality and throughput sections, ``:51-233``, and of its ``main``).

* **quality** — the demo corpus (``data/demo_corpus.py``, ``--genes`` genes
  from ``--seed``) is prepared once (``data/pipeline.py``: block
  ``--block_size``, ``multi`` packing, genome-disjoint splits,
  ``skip_homology``, engine ``native``); dense and top-1/top-2 routed
  variants then train on the same packed arrays with the same seed,
  schedule and steps (only the MLP differs; dropout 0, label smoothing 0,
  ``attention_impl`` left at its default, the einsum path), and each final
  ``last.npz`` is scored by ``evaluate_perplexity`` on the val and test
  splits beside the Markov count baselines fitted on the train split (the
  quality floor). ``--converged_epochs`` (default 30, 0 disables) repeats
  the pass at that budget as ``quality_converged``.
* **throughput** — the 12L8H d512 CodonGPT (block 512, fused QKV, bf16 on
  float32 masters, flash attention, dropout 0.1, label smoothing 0.05),
  dense and with a 4-expert MLP routed top-1 and top-2 at capacity 1.25,
  each takes 2 warm-up and ``--measure_steps`` group steps of 16 x 8 x 512
  synthetic windows (``default_rng(1337)``) with AdamW at lr 3e-4, in a
  fresh subprocess of the port so that running out of memory ends only that
  candidate (and is reported as ``"oom"``). On one card the experts are
  replicated.

    python -m genomics_lm_torch.training.benchmark_moe [--skip_throughput] \\
        [--converged_epochs 0] [--workdir outputs/moe_quality] [--skip_quality] \\
        [--measure_steps 8] [--out report.json] [--merge_into old.json] [--device cpu]

* **ep_analysis** (``--ep_analysis``, JAX's ``:283-414``) — the same
  12L8H d512 model with ``--experts`` experts top-2 at capacity 1.25, bf16,
  dropout 0, block ``--ep_seq_len``, takes one group step of 1 x 8 rows
  (``default_rng(0)``) across 8 ranks (``parallel/launch.py::spawn``; on
  one card they share it over gloo) in two layouts: ``data=8`` with the
  experts replicated and ZeRO-1, and ``data=4 x model=2`` with the experts
  split over the model axis, attention tensor-parallel and ZeRO-1. For
  rank 0 it reports the expert weights' and their moments' bytes and all
  parameters' and moments' bytes, read from the rank's own tensors
  (exact), and the bytes and calls of the collectives of that step by
  operation, counted by the port's collective wrappers
  (``parallel/launch.py::timed``): what the port's ranks send, not JAX's
  partitioned-HLO figures, and no wall time.

Writes one JSON report with JAX's keys (``quality``, ``quality_converged``,
``throughput_d512``, ``ep_analysis``; per throughput candidate also
``peak_memory_bytes`` and ``ms_per_group``; per layout also each rank's
bytes).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]

D512_MODEL = {
    "vocab_size": 68, "block_size": 512, "n_layer": 12, "n_head": 8,
    "n_embd": 512, "dropout": 0.1, "label_smoothing": 0.05, "sep_id": 3,
    "tie_embeddings": True, "attention_impl": "flash",
    "compute_dtype": "bfloat16", "fused_qkv": True,
    "flash_block_q": 512, "flash_block_k": 512, "use_checkpoint": False,
}

OOM_PATTERNS = ("out of memory", "oom", "allocate", "allocation", "hbm capacity")

_PROBE_SOURCE = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.training.optim import build_optimizer
from genomics_lm_torch.training.runtime import device_memory_stats
from genomics_lm_torch.training.train_step import LossConfig, make_train_step

spec = json.loads(sys.argv[1])
device = torch.device(spec.get("device", "cuda"))
cfg = CodonGPTConfig.from_run_config(spec["model"])
G, B, T = spec["grad_accum"], spec["batch_size"], cfg.block_size
torch.manual_seed(1337)
model = CodonGPT(cfg).to(device)
bundle = build_optimizer(spec.get("optim", {"lr": 3e-4, "warmup_steps": 10}), model, 1000)
step = make_train_step(cfg, LossConfig())
rng = np.random.default_rng(1337)
x = rng.integers(4, cfg.vocab_size, (G, B, T)).astype(np.int64)
y = np.roll(x, -1, axis=-1); y[..., -1] = 2
batch = {"x": torch.from_numpy(x).to(device), "y": torch.from_numpy(y).to(device)}
gen = torch.Generator(device=device).manual_seed(0)
warmup, measure = spec.get("warmup_steps", 2), spec.get("measure_steps", 8)
def hard_sync(metrics):
    return float(metrics["total_loss_sum"])
for _ in range(warmup):
    m = step(model, bundle, batch, gen, 1.0)
hard_sync(m)
if device.type == "cuda":
    torch.cuda.reset_peak_memory_stats(device)
t0 = time.perf_counter()
for _ in range(measure):
    m = step(model, bundle, batch, gen, 1.0)
hard_sync(m)
dt = time.perf_counter() - t0
nonpad = int((y != 0).sum())
print(json.dumps({
    "ok": True,
    "nonpad_tokens_per_sec": nonpad * measure / dt,
    "seq_per_sec": G * B * measure / dt,
    "wall_per_step_sec": dt / measure,
    "ms_per_group": dt * 1e3 / measure,
    "padding_fraction": float((y == 0).mean()),
    "device_memory": device_memory_stats(device),
    "peak_memory_bytes": device_memory_stats(device).get("peak_bytes_in_use"),
    "last_loss": float(m["total_loss_sum"]) / max(1, int(m["committed_microbatches"])),
}))
"""


def quality_variants(experts: int):
    """(name, extra model cfg) — identical training budget, only the MLP differs."""
    return [
        ("dense", {}),
        (f"moe_{experts}e_top1", {"moe_experts": experts, "moe_top_k": 1}),
        (f"moe_{experts}e_top2", {"moe_experts": experts, "moe_top_k": 2}),
    ]


def build_dataset(workdir: Path, *, genes: int, block_size: int, seed: int) -> Path:
    """The demo corpus's records TSV and its prepared dataset under ``workdir``."""
    from genomics_lm_torch.data.demo_corpus import main as make_corpus
    from genomics_lm_torch.data.pipeline import prepare_dataset

    records_tsv = workdir / "records.tsv"
    records_tsv.parent.mkdir(parents=True, exist_ok=True)
    make_corpus(["--out", str(records_tsv), "--genes", str(genes), "--seed", str(seed)])
    with records_tsv.open() as f:
        records = [dict(r) for r in csv.DictReader(f, delimiter="\t")]
    dataset_dir = workdir / "dataset"
    prepare_dataset(records, dataset_dir, block_size=block_size, pack_mode="multi",
                    group_by="genome", split_seed=seed, skip_homology=True,
                    audit_engine="native")
    return dataset_dir


def run_quality(args, *, epochs: int | None = None, run_prefix: str = "moe-quality") -> dict:
    """One dense-vs-MoE quality pass at an epoch budget (``--epochs``, or
    ``epochs`` for the converged pass)."""
    import numpy as np

    from genomics_lm_torch.evals.markov import evaluate_baselines, fit_baselines
    from genomics_lm_torch.evals.perplexity import evaluate_perplexity
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.tokenizers.codon import SEP_ID
    from genomics_lm_torch.training.checkpoints import load_checkpoint
    from genomics_lm_torch.training.loop import run_training
    from genomics_lm_torch.utils.device import resolve_device
    from genomics_lm_torch.utils.weights import params_from_jax

    device = resolve_device(args.device)
    epochs = args.epochs if epochs is None else epochs
    workdir = Path(args.workdir)
    dataset_dir = build_dataset(workdir, genes=args.genes, block_size=args.block_size,
                                seed=args.seed)
    block = args.block_size
    shared_cfg = {
        "train_npz": str(dataset_dir / f"train_bs{block}.npz"),
        "val_npz": str(dataset_dir / f"val_bs{block}.npz"),
        "block_size": block,
        "vocab_size": 68,
        "n_layer": args.n_layer,
        "n_head": args.n_head,
        "n_embd": args.n_embd,
        # no per-step noise: the deltas under judgment are a few percent
        "dropout": 0.0,
        "label_smoothing": 0.0,  # val NLL comparable to the Markov baselines
        "tie_embeddings": True,
        "batch_size": args.batch_size,
        "grad_accum_steps": args.grad_accum,
        "lr": args.lr,
        "min_lr": args.lr / 10.0,
        "weight_decay": 0.05,
        "warmup_steps": args.warmup_steps,
        "optimizer": "adamw",
        "scheduler": "cosine",
        "epochs": epochs,
        "seed": args.seed,
        "dataloader_seed": args.seed,
        "early_stop_patience": 0,
        "itos_path": str(dataset_dir / "itos.txt"),
        "use_mmap_dataset": False,
    }

    # the quality floor: the count baselines both model families must beat
    with np.load(dataset_dir / f"train_bs{block}.npz") as z:
        train_x, train_y = z["X"], z["Y"]
    with np.load(dataset_dir / f"val_bs{block}.npz") as z:
        val_x, val_y = z["X"], z["Y"]
    counts = fit_baselines(train_x, train_y, 68, reset_token_ids=frozenset({SEP_ID}))
    baselines, _, _ = evaluate_baselines(val_x, val_y, counts, 68,
                                         reset_token_ids=frozenset({SEP_ID}))

    rows = []
    for name, extra in quality_variants(args.experts):
        cfg = dict(shared_cfg)
        cfg.update(extra)
        cfg["run_id"] = f"{run_prefix}-{name}"
        print(f"[{run_prefix}] training {name} (epochs={epochs}) ...", flush=True)
        t0 = time.perf_counter()
        meta = run_training(cfg, run_root=workdir / "runs", device=device, progress_every=0)
        wall = time.perf_counter() - t0
        last = workdir / "runs" / cfg["run_id"] / "checkpoints" / "last.npz"
        model_cfg = CodonGPTConfig.from_run_config(cfg)
        model = params_from_jax(load_checkpoint(last)["model"], model_cfg, device)
        evals = {
            split: evaluate_perplexity(model, model_cfg, dataset_dir / f"{split}_bs{block}.npz")
            for split in ("val", "test")
        }
        row = {
            "name": name,
            "moe": extra or None,
            "n_params": meta["n_params"],
            "best_val_loss": meta["best_val_loss"],
            "train_wall_sec": meta["train_wall_sec"],
            "wall_sec_total": round(wall, 2),
            "val_nll": evals["val"]["nll"],
            "val_ppl": evals["val"]["perplexity"],
            "test_nll": evals["test"]["nll"],
            "test_ppl": evals["test"]["perplexity"],
            "beats_all_markov_baselines": bool(
                evals["val"]["nll"] < min(b["cross_entropy_nats"] for b in baselines.values())),
        }
        print(f"[moe-quality]   -> val ppl {row['val_ppl']:.3f} test ppl {row['test_ppl']:.3f} "
              f"({row['n_params']:,} params, {row['train_wall_sec']:.0f}s)", flush=True)
        rows.append(row)

    dense = next(r for r in rows if r["name"] == "dense")
    for r in rows:
        r["val_nll_delta_vs_dense"] = r["val_nll"] - dense["val_nll"]
    return {
        "protocol": {
            "corpus": f"make_demo_corpus genes={args.genes} seed={args.seed}",
            "budget": f"epochs={epochs} b{args.batch_size}x{args.grad_accum} "
                      f"lr={args.lr} (identical for every variant)",
            "model": f"{args.n_layer}L{args.n_head}H d{args.n_embd} "
                     f"block{block}, dropout 0, label smoothing 0",
            "evaluator": "evals/perplexity.py exact corpus NLL, shared across variants",
        },
        "markov_baselines": {k: v["cross_entropy_nats"] for k, v in baselines.items()},
        "variants": rows,
    }


def run_candidate_subprocess(spec: dict, timeout: float = 900.0) -> dict:
    """Run one candidate in a fresh process; classify out-of-memory failures."""
    source = _PROBE_SOURCE.replace("{repo!r}", repr(str(REPO_ROOT)))
    try:
        proc = subprocess.run(
            [sys.executable, "-c", source, json.dumps(spec)],
            capture_output=True, text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": "timeout"}
    if proc.returncode != 0:
        blob = (proc.stderr + proc.stdout).lower()
        return {
            "ok": False,
            "error": "oom" if any(p in blob for p in OOM_PATTERNS) else "failed",
            "detail": proc.stderr.strip()[-2000:],
        }
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return {"ok": False, "error": "no-output"}


def run_throughput(args, *, model: dict = D512_MODEL, batch_size: int = 8,
                   grad_accum: int = 16, device: str = "cuda", top_ks=(1, 2)) -> dict:
    """Dense and the top-k candidates (top-1 and top-2, as the CLI runs
    them), each in its own subprocess."""
    rows = []
    cands = [("dense", {})]
    for top_k in top_ks:
        cands.append((f"moe_{args.experts}e_top{top_k}",
                      {"moe_experts": args.experts, "moe_top_k": top_k,
                       "moe_capacity_factor": 1.25}))
    for name, extra in cands:
        spec = {"model": {**model, **extra}, "batch_size": batch_size,
                "grad_accum": grad_accum, "measure_steps": args.measure_steps,
                "warmup_steps": 2, "device": device}
        print(f"[moe-throughput] {name} (b{batch_size}x{grad_accum} "
              f"d{model['n_embd']}) ...", flush=True)
        res = run_candidate_subprocess(spec, timeout=args.timeout)
        row = {"name": name, "moe": extra or None, **res}
        if res.get("ok"):
            row["tok_per_sec"] = res["nonpad_tokens_per_sec"]
            print(f"[moe-throughput]   -> {row['tok_per_sec']:,.0f} tok/s", flush=True)
        else:
            print(f"[moe-throughput]   -> {res.get('error')}", flush=True)
        rows.append(row)
    dense = next((r for r in rows if r["name"] == "dense" and r.get("ok")), None)
    if dense:
        for r in rows:
            if r.get("ok"):
                r["rel_to_dense"] = round(r["tok_per_sec"] / dense["tok_per_sec"], 3)
    return {
        "protocol": f"{model['n_layer']}L{model['n_head']}H d{model['n_embd']} block"
                    f"{model['block_size']} b{batch_size}x{grad_accum}, a fresh subprocess "
                    "per candidate; one card, experts replicated",
        "candidates": rows,
    }


def run_ep_analysis(args, *, model: dict = D512_MODEL, device: str = "cuda:0",
                    world: int = 8) -> dict:
    """Experts split over the model axis against experts replicated: each
    layout's exact bytes on rank 0 and its collectives in one group step
    (JAX's ``run_ep_analysis``, over ``world`` ranks on ``device``)."""
    import numpy as np
    import torch

    from genomics_lm_torch.models.codon_gpt import CodonGPT
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.parallel import launch, workers
    from genomics_lm_torch.utils.weights import params_to_jax

    seq = int(args.ep_seq_len)
    kw = dict(model, block_size=seq, compute_dtype="bfloat16", dropout=0.0,
              moe_experts=args.experts, moe_top_k=2, moe_capacity_factor=1.25)
    cfg = CodonGPTConfig.from_run_config(kw)
    torch.manual_seed(0)
    tree = params_to_jax(CodonGPT(cfg), cfg)
    rng = np.random.default_rng(0)
    batch = tuple(rng.integers(4, 68, (1, 8, seq)).astype(np.int64) for _ in range(2))
    layouts = (("replicated", "data=8 (experts replicated, ZeRO-1)", {"data": world}),
               ("ep_sharded", "data=4 x model=2 (EP over model, attention TP, ZeRO-1)",
                {"data": world // 2, "model": 2}))
    spec = {"model": dataclasses.asdict(cfg), "tree": tree, "groups": [batch], "total_steps": 10,
            "run_cfg": {"lr": 3e-4, "warmup_steps": 0, "weight_decay": 1e-4,
                        "shard_optimizer_state": True},
            "return_tree": False, "return_grads": False, "device": device}
    ranks = launch.spawn(workers.group_steps, world,
                         [dict(spec, axes=axes) for _, _, axes in layouts], device=device)
    report = {"protocol": (
        f"{world} ranks on {device} (parallel/launch.py), {args.experts}-expert top-2 "
        f"d{cfg.n_embd} MoE, b8 seq{seq}, one group step; memory from each rank's own "
        "tensors (exact), communication from the port's collective wrappers' output bytes "
        "(what the ranks send; not JAX's partitioned-HLO figures; no wall time)")}
    for i, (key, name, _) in enumerate(layouts):
        r0 = ranks[0][i]
        report[key] = {
            "mesh": name,
            "expert_weight_bytes_per_device": r0["expert_bytes"],
            "expert_moment_bytes_per_device": r0["expert_state_bytes"],
            "total_param_bytes_per_device": r0["param_bytes"],
            "total_moment_bytes_per_device": r0["state_bytes"],
            "collectives_per_step": {
                "bytes_by_op": r0["collective_bytes"], "count_by_op": r0["collective_counts"],
                "total_bytes": int(sum(r0["collective_bytes"].values()))},
            "per_rank": [{k: r[i][k] for k in ("expert_bytes", "expert_state_bytes",
                                               "param_bytes", "state_bytes")} for r in ranks],
        }
        print(f"[ep-analysis] {name}: expert weights "
              f"{r0['expert_bytes'] / 2**20:.1f} MiB/rank, moments "
              f"{r0['expert_state_bytes'] / 2**20:.1f} MiB/rank, collectives "
              f"{report[key]['collectives_per_step']['total_bytes'] / 2**20:.1f} MiB/step",
              flush=True)
    report["expert_memory_ratio"] = round(
        report["ep_sharded"]["expert_weight_bytes_per_device"]
        / max(1, report["replicated"]["expert_weight_bytes_per_device"]), 3)
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="MoE-vs-dense quality and d512 throughput")
    ap.add_argument("--out", default="outputs/benchmarks/moe_benchmark_torch.json")
    ap.add_argument("--workdir", default="outputs/moe_quality")
    ap.add_argument("--genes", type=int, default=800)
    ap.add_argument("--block_size", type=int, default=256)
    ap.add_argument("--n_layer", type=int, default=6)
    ap.add_argument("--n_head", type=int, default=4)
    ap.add_argument("--n_embd", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--converged_epochs", type=int, default=30,
                    help="second quality pass at this saturated budget "
                         "(emits quality_converged; 0 disables)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup_steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--measure_steps", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=1700.0)
    ap.add_argument("--skip_quality", action="store_true")
    ap.add_argument("--skip_throughput", action="store_true")
    ap.add_argument("--merge_into", default=None,
                    help="read this existing artifact and merge new sections into it "
                         "instead of writing only the sections run")
    ap.add_argument("--device", default=None,
                    help="torch device of the quality runs and the throughput candidates "
                         "(default: the CUDA card)")
    ap.add_argument("--ep_analysis", action="store_true",
                    help="EP-vs-replicated memory and collective bytes across 8 ranks "
                         "(sharing the card over gloo, or --device cpu)")
    ap.add_argument("--ep_seq_len", type=int, default=512)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    report: dict = {}
    if args.merge_into:
        report = json.loads(Path(args.merge_into).read_text())
    if not args.skip_quality:
        report["quality"] = run_quality(args)
        if args.converged_epochs:
            report["quality_converged"] = run_quality(
                args, epochs=args.converged_epochs, run_prefix="moe-quality-conv")
    if not args.skip_throughput:
        report["throughput_d512"] = run_throughput(args, device=args.device or "cuda")
    if args.ep_analysis:
        report["ep_analysis"] = run_ep_analysis(args, device=args.device or "cuda:0")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    for section in ("quality", "quality_converged", "throughput_d512", "ep_analysis"):
        if section in report:
            print(json.dumps({section: report[section]}), flush=True)
    print(f"[moe-benchmark] wrote {out}")
    return 0


__all__ = ["D512_MODEL", "build_dataset", "main", "parser", "quality_variants",
           "run_candidate_subprocess", "run_ep_analysis", "run_quality", "run_throughput"]


if __name__ == "__main__":
    raise SystemExit(main())
