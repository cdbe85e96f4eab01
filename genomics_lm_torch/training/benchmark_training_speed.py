"""Training-throughput sweep over batch x accumulation candidates, each in
its own subprocess (twin of ``scripts/benchmark_training_speed.py``, the
same flags plus ``--device``).

    python -m genomics_lm_torch.training.benchmark_training_speed \\
        [--candidates 4x32,8x16 | --matrix matrix.yaml] [--config base.yaml] \\
        [--measure_steps 8] [--out outputs/benchmarks/training_speed.json] [--device cpu]

The jobs are the script's: ``--matrix`` applies each named override map to
its ``base:`` (``batch_size`` and ``grad_accum_steps`` pick the group
shape, the rest the model), else ``--candidates`` or
``DEFAULT_CANDIDATES``, over the base model (10L8H d384, block 512, flash
attention in bfloat16, ``--config`` merged in). Each candidate runs in a
fresh ``python -c`` process that imports only this package: seed 1337, 2
warm-up steps, then ``measure_steps`` steps between two syncs on
``total_loss_sum``; it prints one JSON line with the script's keys, the
card's memory from ``training/runtime.py::device_memory_stats``. The
probe runs on ``--device`` (default: the CUDA card); on the card it loads
the flash kernels from the build cache that ``kernels/build.py`` keeps, so
build them before a sweep (the first candidate builds them otherwise), and
logs whether it found them there. A failure is classified as the script
classifies it: ``oom`` when the output names an allocation
(``OOM_PATTERNS``: PyTorch's "CUDA out of memory. Tried to allocate ..."
matches), ``timeout``, else ``failed``. ``selected_policy`` is the
fastest candidate that ran.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]

OOM_PATTERNS = ("out of memory", "oom", "allocate", "allocation", "hbm capacity")
PROBE_LOG = "[probe]"  # the probe's log lines, echoed by the parent

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
from genomics_lm_torch.utils.device import resolve_device

spec = json.loads(sys.argv[1])
device = resolve_device(spec.get("device"))
cfg = CodonGPTConfig.from_run_config(spec["model"])
if device.type == "cuda" and cfg.attention_impl == "flash":
    from genomics_lm_torch.kernels.build import library_path, load
    t0 = time.perf_counter()
    cached = library_path("flash_attention").exists()
    load("flash_attention")
    print(f"[probe] flash_attention {'loaded from the build cache' if cached else 'built'} "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
G, B, T = spec["grad_accum"], spec["batch_size"], cfg.block_size
torch.manual_seed(1337)
model = CodonGPT(cfg).to(device)
bundle = build_optimizer(spec.get("optim", {"lr": 3e-4, "warmup_steps": 10}), model, 1000)
step = make_train_step(cfg, LossConfig())
rng = np.random.default_rng(1337)
x = rng.integers(4, cfg.vocab_size, (G, B, T)).astype(np.int32)
y = np.roll(x, -1, axis=-1); y[..., -1] = 2
batch = {"x": torch.from_numpy(x).long().to(device), "y": torch.from_numpy(y).long().to(device)}
gen = torch.Generator(device=device).manual_seed(0)
warmup, measure = spec.get("warmup_steps", 2), spec.get("measure_steps", 8)
def hard_sync(metrics):
    value = float(metrics["total_loss_sum"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return value
for _ in range(warmup):
    m = step(model, bundle, batch, gen, 1.0)
hard_sync(m)
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
    "padding_fraction": float((y == 0).mean()),
    "device_memory": device_memory_stats(device),
}))
"""


def run_candidate_subprocess(spec: dict, timeout: float = 900.0) -> dict:
    """Run one candidate in a fresh process; classify OOM failures. The
    probe's ``[probe]`` log lines are printed here."""
    source = _PROBE_SOURCE.replace("{repo!r}", repr(str(REPO_ROOT)))
    try:
        proc = subprocess.run(
            [sys.executable, "-c", source, json.dumps(spec)],
            capture_output=True, text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": "timeout"}
    for line in proc.stdout.splitlines():
        if line.startswith(PROBE_LOG):
            print(line, flush=True)
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


DEFAULT_CANDIDATES = [(4, 32), (8, 16), (16, 8), (32, 4), (64, 2), (128, 1)]


def build_jobs(args) -> list[tuple[str, dict]]:
    """(name, probe spec) for each candidate, as the script builds them; each
    spec carries ``device`` (None: the card)."""
    import yaml

    base_model = {
        "vocab_size": 68, "block_size": 512, "n_layer": 10, "n_head": 8,
        "n_embd": 384, "dropout": 0.1, "label_smoothing": 0.05,
        "attention_impl": "flash", "compute_dtype": "bfloat16",
    }
    if args.config:
        base_model.update(yaml.safe_load(Path(args.config).read_text()) or {})

    jobs = []
    if args.matrix:
        matrix = yaml.safe_load(Path(args.matrix).read_text()) or {}
        base = matrix.get("base", {})
        for name, overrides in (matrix.get("overrides") or {}).items():
            model = dict(base_model)
            spec_base = dict(base)
            spec_base.update(overrides or {})
            model.update({k: v for k, v in spec_base.items()
                          if k not in {"batch_size", "grad_accum_steps"}})
            jobs.append((name, {
                "model": model,
                "batch_size": int(spec_base.get("batch_size", 8)),
                "grad_accum": int(spec_base.get("grad_accum_steps", 16)),
                "measure_steps": args.measure_steps,
            }))
    else:
        if args.candidates:
            candidates = [
                tuple(int(v) for v in c.split("x")) for c in args.candidates.split(",")
            ]
        else:
            candidates = DEFAULT_CANDIDATES
        for batch, gacc in candidates:
            jobs.append((f"b{batch}x{gacc}", {
                "model": base_model,
                "batch_size": batch,
                "grad_accum": gacc,
                "measure_steps": args.measure_steps,
            }))
    for _, spec in jobs:
        spec["device"] = args.device
    return jobs


def select_policy(results: list[dict]) -> dict | None:
    """The fastest candidate that ran, by non-pad tokens/s (None if none did)."""
    ok = [r for r in results if r.get("ok")]
    return max(ok, key=lambda r: r["nonpad_tokens_per_sec"]) if ok else None


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None, help="base YAML model config")
    ap.add_argument("--candidates", default=None,
                    help="comma list like 4x32,8x16 (batch x gacc)")
    ap.add_argument("--matrix", default=None,
                    help="YAML with base: + named override maps")
    ap.add_argument("--measure_steps", type=int, default=8)
    ap.add_argument("--out", default="outputs/benchmarks/training_speed.json")
    ap.add_argument("--device", default=None,
                    help="the probes' torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    results = []
    for name, spec in build_jobs(args):
        print(f"[bench] {name} ...", flush=True)
        result = run_candidate_subprocess(spec)
        result["name"] = name
        result["batch_size"] = spec["batch_size"]
        result["grad_accum"] = spec["grad_accum"]
        results.append(result)
        if result.get("ok"):
            print(f"[bench] {name}: {result['nonpad_tokens_per_sec']:.1f} tok/s")
        else:
            print(f"[bench] {name}: {result['error']}")

    best = select_policy(results)
    report = {"results": results, "selected_policy": best}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    if best:
        print(f"[bench] selected: {best['name']} @ {best['nonpad_tokens_per_sec']:.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
