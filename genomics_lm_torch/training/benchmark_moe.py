"""MoE-vs-dense training throughput at the flagship width (twin of the
throughput section of ``scripts/benchmark_moe.py:198-233`` over the probe
of ``scripts/benchmark_training_speed.py:29-99``).

The 12L8H d512 CodonGPT (block 512, fused QKV, bf16 on float32 masters,
flash attention, dropout 0.1, label smoothing 0.05), dense and with a
4-expert MLP routed top-1 and top-2 at capacity 1.25, each takes 2 warm-up
and ``--measure_steps`` group steps of 16 x 8 x 512 synthetic windows
(``default_rng(1337)``) with AdamW at lr 3e-4, in a fresh subprocess of
the port so that running out of memory ends only that candidate (and is
reported as ``"oom"``). On one card the experts are replicated.

    python -m genomics_lm_torch.training.benchmark_moe [--measure_steps 8] \\
        [--experts 4] [--timeout 1700] [--out report.json] [--merge_into old.json]

Writes one JSON report with JAX's keys (``throughput_d512``: per
candidate ``nonpad_tokens_per_sec``, ``wall_per_step_sec``,
``device_memory``, ``rel_to_dense``), plus each candidate's
``peak_memory_bytes`` and ``ms_per_group``. The quality section
(``--skip_quality`` is implied) and the expert-parallel analysis need the
demo-corpus pipeline, the Markov baselines and a mesh, which the port does
not have: their flags raise ``NotImplementedError`` naming the flag, and
so does ``--skip_throughput``, which would leave nothing to run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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

# the quality and expert-parallel flags of scripts/benchmark_moe.py
UNPORTED_FLAGS = ("workdir", "genes", "block_size", "n_layer", "n_head", "n_embd",
                  "batch_size", "grad_accum", "epochs", "converged_epochs", "lr",
                  "warmup_steps", "seed", "ep_analysis", "ep_seq_len", "skip_throughput")

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
                   grad_accum: int = 16, device: str = "cuda") -> dict:
    """Dense, top-1 and top-2 candidates, each in its own subprocess."""
    rows = []
    cands = [("dense", {})]
    for top_k in (1, 2):
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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="MoE-vs-dense training throughput at d512")
    ap.add_argument("--out", default="outputs/benchmarks/moe_benchmark_torch.json")
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--measure_steps", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=1700.0)
    ap.add_argument("--skip_quality", action="store_true",
                    help="implied: the quality section is not ported")
    ap.add_argument("--merge_into", default=None,
                    help="read this existing artifact and merge the new section into it")
    ap.add_argument("--device", default="cuda", help="torch device of the candidates")
    for flag in UNPORTED_FLAGS:
        ap.add_argument(f"--{flag}", default=None,
                        action="store_true" if flag in ("ep_analysis", "skip_throughput")
                        else "store")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    for flag in UNPORTED_FLAGS:
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(
                f"--{flag} is not ported: the quality and expert-parallel sections need "
                "the demo-corpus pipeline, the Markov baselines and a mesh")
    report: dict = {}
    if args.merge_into:
        report = json.loads(Path(args.merge_into).read_text())
    report["throughput_d512"] = run_throughput(args, device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report["throughput_d512"]), flush=True)
    print(f"[moe-benchmark] wrote {out}")
    return 0


__all__ = ["D512_MODEL", "main", "parser", "run_candidate_subprocess", "run_throughput"]


if __name__ == "__main__":
    raise SystemExit(main())
