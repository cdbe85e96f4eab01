"""Where a serving drain's time goes on the card.

Runs the serving main path that ``chip_smoke.py`` drives (the constants
below: 10L8H d384 CodonGPT, block 512, bf16, fused QKV, random weights
from a seed; 64 slots, max_seq_len 256, 16 steps per sync; 128 requests)
once without and once under ``torch.profiler``, and prints JSON lines:
the drain's wall time, the device time summed over every kernel, the
device's busy share (of the unprofiled drain, and of the profiled one),
kernel launches per decode step (per verify round with ``--speculative``),
and the kernels that take the most device time. ``--speculative K`` serves
the same requests by speculative decoding with K drafted tokens per round,
from a bigram draft table fitted as ``scripts/benchmark_serving.py`` fits
it (``fit_draft_table``). ``--int8_weights`` quantizes the model's block
linears first (``ops/quant.py::quantize_params``). Needs a CUDA card:

    python -m genomics_lm_torch.serving.profile_drain [--kv_quant] [--int8_weights] \
        [--speculative K] [--top 12]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from genomics_lm_torch.generation.decode import generate_tokens
from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.quant import quantize_params
from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.serving.speculative import fit_bigram_table

# The serving main path (scripts/benchmark_serving.py:31-43,73-82), shared
# with chip_smoke.py: the model, the engine, and the traffic of REQUESTS
# requests with prompts of 16-64 tokens and budgets of 32-128, half greedy
# and half at temperature 1.0.
MAIN = dict(vocab_size=68, block_size=512, n_layer=10, n_head=8, n_embd=384,
            dropout=0.0, sep_id=3, compute_dtype="bfloat16", fused_qkv=True,
            attention_impl="flash")
ENGINE = dict(slots=64, max_seq_len=256, steps_per_sync=16)
REQUESTS = 128
SPECULATIVE_K = 4  # scripts/benchmark_speculative.py's default draft length


def build_requests(rng, n: int) -> list[tuple[list[int], int, float]]:
    """``n`` (prompt, budget, temperature) requests drawn from ``rng``."""
    out = []
    for i in range(n):
        p_len = int(rng.integers(16, 65))
        budget = min(int(rng.integers(32, 129)), ENGINE["max_seq_len"] - p_len)
        prompt = [1] + [int(t) for t in rng.integers(4, 68, p_len - 1)]
        out.append((prompt, budget, 0.0 if i % 2 == 0 else 1.0))
    return out


def fit_draft_table(model, cfg, kv_quant: bool = False, seed: int = 42,
                    tokens: int = 256) -> np.ndarray:
    """The bigram draft table of ``scripts/benchmark_serving.py:91-105``:
    fitted to ``tokens`` tokens (256 there; at most block_size - 16) that the
    model samples at temperature 1.0 after each of 8 prompts of 16 random
    codon ids. The prompts and draws come from ``seed``, apart from the
    requests."""
    device = next(model.parameters()).device
    prompts = np.random.default_rng(seed).integers(4, 68, (8, 16))
    gen = torch.Generator(device=device).manual_seed(seed)
    stream = generate_tokens(model, cfg, prompts, min(tokens, cfg.block_size - 16), gen, 1.0,
                             kv_quant, device=device)
    return fit_bigram_table(list(stream.cpu().numpy()), cfg.vocab_size)


def _drain(model, cfg, reqs, kv_quant, spec_kw):
    eng = ServingEngine(model, cfg, **ENGINE, kv_quant=kv_quant, device="cuda", **spec_kw)
    for prompt, budget, temp in reqs:
        eng.submit(prompt, budget, temperature=temp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, sum(len(r.tokens) for r in results.values()), eng.stats()


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv_quant", action="store_true")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decoding with K drafted tokens per verify round")
    ap.add_argument("--int8_weights", action="store_true",
                    help="weight-only int8 block linears (ops/quant.py)")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_drain needs a CUDA device")

    cfg = CodonGPTConfig(**MAIN)
    torch.manual_seed(0)
    model = CodonGPT(cfg).to("cuda").eval()
    if args.int8_weights:
        model = quantize_params(model)
    spec_kw = {}
    if args.speculative:
        spec_kw = {"speculative_k": args.speculative,
                   "draft_table": fit_draft_table(model, cfg, args.kv_quant)}
    rng = np.random.default_rng(0)
    _drain(model, cfg, build_requests(rng, 8), args.kv_quant, spec_kw)  # warm-up
    reqs = build_requests(rng, REQUESTS)
    plain_s, delivered, stats = _drain(model, cfg, reqs, args.kv_quant, spec_kw)
    # the host's unit of work: a decode step, or a verify round (whose count
    # varies from drain to drain with the draws)
    unit = "verify_round" if args.speculative else "decode_step"
    steps = stats[f"{unit}s"]

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        prof_s, _, prof_stats = _drain(model, cfg, reqs, args.kv_quant, spec_kw)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    report = {
        "card": torch.cuda.get_device_name(0), "kv_quant": args.kv_quant,
        "int8_weights": args.int8_weights,
        "speculative_k": args.speculative,
        "requests": REQUESTS, "delivered_tokens": delivered, f"{unit}s": steps,
        "drain_s": plain_s, "profiled_drain_s": prof_s,
        "delivered_tokens_per_s": delivered / plain_s,
        f"host_ms_per_{unit}": plain_s * 1e3 / steps,
        "device_ms": device_us / 1e3,
        # the profiler slows the host, not the kernels: the busy share of the
        # unprofiled drain divides the same device time by its wall time (a
        # speculative drain's round count varies a little with its draws)
        "device_busy_share": device_us / 1e6 / plain_s,
        "device_busy_share_profiled": device_us / 1e6 / prof_s,
        "kernel_launches": launches,
        f"kernel_launches_per_{unit}": launches / prof_stats[f"{unit}s"],
    }
    for key in ("speculative_accept_rate", "speculative_tokens_per_round"):
        if key in stats:
            report[key] = stats[key]
    print(json.dumps(report))
    for e in sorted(kernels, key=_device_us, reverse=True)[: args.top]:
        print(json.dumps({"kernel": e.key[:120], "count": e.count,
                          "device_ms": _device_us(e) / 1e3,
                          "share_of_device": _device_us(e) / device_us}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
