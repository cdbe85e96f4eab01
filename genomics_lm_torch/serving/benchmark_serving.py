"""Continuous-batching serving throughput under a ragged request mix (twin
of ``scripts/benchmark_serving.py``: the same flags and the same JSON
report, plus ``--device``).

A queue of requests with varying prompt lengths and token budgets drains
through a fixed slot pool of ``ServingEngine`` — admissions, chunked
ragged decode, retirements, slot reuse. The metric counts only tokens
delivered to requests (overshoot past a stop or budget inside a chunk is
excluded): the median of ``--repeats`` drains of the same queue. With
``--arrival_rate`` > 0 it runs the open-loop Poisson latency protocol
instead (``utils/cli.py::poisson_latency_drain``) and reports TTFT and ITL
percentiles.

The model is the JAX script's, with random weights from a seed: bf16,
fused QKV and the CUDA kernels on the card, float32 and the einsum path on
the CPU (the JAX script's non-TPU choice); ``--int8_weights`` quantizes
its block linears (``ops/quant.py``).

    python -m genomics_lm_torch.serving.benchmark_serving [--int8_weights] \
        [--kv_quant] [--speculative 4] [--arrival_rate 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_layer", type=int, default=10)
    ap.add_argument("--n_head", type=int, default=8)
    ap.add_argument("--n_embd", type=int, default=384)
    ap.add_argument("--block_size", type=int, default=512)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--max_seq_len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--prompt_len_min", type=int, default=16)
    ap.add_argument("--prompt_len_max", type=int, default=64)
    ap.add_argument("--new_tokens_min", type=int, default=32)
    ap.add_argument("--new_tokens_max", type=int, default=128)
    ap.add_argument("--steps_per_sync", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--kv_quant", action="store_true",
                    help="int8 KV cache with per-vector scales")
    ap.add_argument("--int8_weights", action="store_true",
                    help="weight-only int8 block linears (ops/quant.py)")
    ap.add_argument("--arrival_rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate (req/s); > 0 switches "
                         "to the latency protocol (TTFT/ITL percentiles)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decoding with K bigram-drafted tokens "
                         "per verify round (serving/speculative.py); the "
                         "draft table is fitted to a model-sampled stream")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous drain (no chunk pipelining)")
    ap.add_argument("--pipeline_depth", type=int, default=1,
                    help="chunks kept in flight during retirement")
    ap.add_argument("--repeats", type=int, default=5,
                    help="median-of-N drains for the throughput headline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def run(args) -> dict:
    """Build the model, drain the queue, return the report ``main`` prints."""
    from genomics_lm_torch.generation.decode import generate_tokens
    from genomics_lm_torch.models.codon_gpt import CodonGPT
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.ops.quant import quantize_params
    from genomics_lm_torch.serving.engine import ServingEngine
    from genomics_lm_torch.serving.speculative import fit_bigram_table
    from genomics_lm_torch.utils.cli import latency_percentiles, poisson_latency_drain
    from genomics_lm_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = CodonGPTConfig(
        vocab_size=68, block_size=args.block_size, n_layer=args.n_layer,
        n_head=args.n_head, n_embd=args.n_embd, dropout=0.0, sep_id=3,
        compute_dtype="bfloat16" if on_card else "float32",
        fused_qkv=on_card,
        attention_impl="flash" if on_card else "xla",
    )
    torch.manual_seed(0)
    model = CodonGPT(cfg).to(device).eval()
    if args.int8_weights:
        model = quantize_params(model)

    rng = np.random.default_rng(args.seed)

    spec_kw = {}
    if args.speculative:
        seed_prompt = rng.integers(4, 68, (8, 16))
        stream = generate_tokens(
            model, cfg, seed_prompt, min(256, args.block_size - 16),
            torch.Generator(device=device).manual_seed(42), 1.0, args.kv_quant,
            device=device).cpu().numpy()
        spec_kw = {"speculative_k": args.speculative,
                   "draft_table": fit_bigram_table([r for r in stream], cfg.vocab_size)}

    def build_queue(n):
        reqs = []
        for _ in range(n):
            p_len = int(rng.integers(args.prompt_len_min, args.prompt_len_max + 1))
            budget = int(rng.integers(args.new_tokens_min, args.new_tokens_max + 1))
            budget = min(budget, args.max_seq_len - p_len)
            prompt = [1] + [int(t) for t in rng.integers(4, 68, p_len - 1)]
            reqs.append((prompt, budget))
        return reqs

    def engine(seed):
        return ServingEngine(
            model, cfg, slots=args.slots, max_seq_len=args.max_seq_len,
            kv_quant=args.kv_quant, steps_per_sync=args.steps_per_sync,
            seed=seed, pipeline_depth=args.pipeline_depth, device=device, **spec_kw)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def run_queue(reqs, seed):
        eng = engine(seed)
        for prompt, budget in reqs:
            eng.submit(prompt, budget, temperature=args.temperature)
        results = eng.run(pipelined=not args.sync)
        return sum(len(r.tokens) for r in results.values())

    # warm on a small queue (cuBLAS handles, the allocator, the kernels' build)
    run_queue(build_queue(min(args.slots, args.requests)), args.seed + 1)
    common = {
        "requests": args.requests,
        "slots": args.slots,
        "steps_per_sync": args.steps_per_sync,
        "pipeline_depth": args.pipeline_depth,
        "kv_quant": bool(args.kv_quant),
        "int8_weights": bool(args.int8_weights),
        "speculative_k": args.speculative,
        "model": f"{args.n_layer}L{args.n_head}H d{args.n_embd}",
        "device": str(device),
    }

    if args.arrival_rate > 0:
        reqs = build_queue(args.requests)
        sync()
        ttft, itl, delivered, elapsed = poisson_latency_drain(
            engine(args.seed), [(p, b, args.temperature) for p, b in reqs],
            args.arrival_rate, seed=args.seed, pipelined=not args.sync)
        lat = latency_percentiles(ttft, itl)
        return {
            "metric": "serving_latency_ms",
            "value": lat["ttft_p50_ms"],
            "unit": "ms_ttft_p50",
            **lat,
            "arrival_rate_req_per_sec": args.arrival_rate,
            "throughput_tok_per_sec": round(delivered / elapsed, 1),
            "ttft_ms": [t * 1e3 for t in ttft],
            **common,
        }

    # median-of-N with dispersion: every sample drains the same queue
    samples = []
    delivered = 0
    reqs = build_queue(args.requests)
    for _ in range(max(1, args.repeats)):
        sync()
        t0 = time.perf_counter()
        delivered = run_queue(reqs, args.seed)  # the results fetch syncs
        elapsed = time.perf_counter() - t0
        samples.append(delivered / elapsed)
    samples.sort()
    median = float(np.median(samples))
    spread_pct = 100.0 * (samples[-1] - samples[0]) / median if median else 0.0
    return {
        "metric": "serving_delivered_tokens_per_sec_per_chip",
        "value": round(median, 1),
        "unit": "tokens/sec",
        "repeats": len(samples),
        "samples_tok_per_sec": [round(s, 1) for s in samples],
        "min_max_spread_pct": round(spread_pct, 1),
        "delivered_tokens": delivered,
        "max_seq_len": args.max_seq_len,
        **common,
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    report = run(args)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
