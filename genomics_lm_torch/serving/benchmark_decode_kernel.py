"""Times the L-layer decode-attention chain per implementation on the card.

Twin of ``scripts/benchmark_decode_kernel.py``: it times ONLY the per-step
attention chain (L layers of single-token attention against the packed
cache), so kernel time is told apart from the rest of a decode step. The
implementations are ``plain`` (``decode_attention_reference``), ``blocked``
(``decode_attention``, the single-pass CUDA kernel) and ``streamed``
(``decode_attention_streamed``, the split-S CUDA kernel). The defaults are
the script's: 10 layers, 8 heads of 48, batch 256, 256 cache slots, a bf16
cache (``--kv_quant``: int8 with per-vector scales), every row attending a
random prefix of S/4 to S positions. Inputs are drawn on the card from a
seed. Each chain is timed queued (``utils.timing.median_ms``), and printed
beside its least time, the cache-read bound. Needs a CUDA card:

    python -m genomics_lm_torch.serving.benchmark_decode_kernel [--kv_quant] \
        [--batch_size 256] [--impls plain,blocked,streamed] [--block_s N]
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from genomics_lm_torch.ops.decode_attention import (
    NEG_INF,
    decode_attention,
    decode_attention_reference,
    decode_attention_streamed,
)
from genomics_lm_torch.ops.quant import quantize_kv
from genomics_lm_torch.utils.timing import card_peaks, decode_bound_ms, median_ms


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_layer", type=int, default=10)
    ap.add_argument("--n_head", type=int, default=8)
    ap.add_argument("--kv_heads", type=int, default=None)
    ap.add_argument("--head_dim", type=int, default=48)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--cache_slots", type=int, default=256,
                    help="S, the horizon-bucketed cache length")
    ap.add_argument("--kv_quant", action="store_true")
    ap.add_argument("--impls", default="plain,blocked,streamed",
                    help="comma list of plain|blocked|streamed")
    ap.add_argument("--block_s", type=int, default=None,
                    help="positions per split of the streamed kernel")
    ap.add_argument("--runs", type=int, default=25, help="median of N timed chains")
    return ap.parse_args(argv)


def make_inputs(args, device="cuda"):
    """q (B, Hq, D) bf16, packed (L, B, S, P) caches (bf16, or int8 with
    (L, B, Hkv, S) scales) and a ragged (B, S) prefix mask, on ``device``."""
    L, B, S = args.n_layer, args.batch_size, args.cache_slots
    Hq, D = args.n_head, args.head_dim
    Hkv = args.kv_heads or Hq
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
    lengths = torch.randint(S // 4, S, (B,), generator=gen, device=device)
    mask = torch.zeros((B, S), device=device)
    mask.masked_fill_(torch.arange(S, device=device)[None, :] >= lengths[:, None], NEG_INF)

    def cache():
        x = torch.randn((L, B, Hkv, S, D), generator=gen, device=device)
        scale = None
        if args.kv_quant:
            x, scale = quantize_kv(x)
        packed = x.transpose(2, 3).reshape(L, B, S, Hkv * D)
        return packed.to(torch.int8 if args.kv_quant else torch.bfloat16).contiguous(), scale

    k, ks = cache()
    v, vs = cache()
    return q, k, v, mask, ks, vs


def run(args) -> dict:
    """Time each implementation's chain; returns the report."""
    q, k, v, mask, ks, vs = make_inputs(args)
    L = args.n_layer
    Hkv = k.shape[3] // args.head_dim
    impls = {
        "plain": decode_attention_reference,
        "blocked": decode_attention,
        "streamed": functools.partial(decode_attention_streamed, block_s=args.block_s),
    }

    def chain(fn):
        for layer in range(L):
            fn(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)

    results = {}
    for name in args.impls.split(","):
        fn = impls[name.strip()]
        chain_ms = median_ms(lambda: chain(fn), runs=args.runs)
        results[name.strip()] = {"chain_ms": chain_ms, "per_layer_us": chain_ms / L * 1e3}
    kind = torch.cuda.get_device_name(0)
    peak_bw, peak_ops = card_peaks(kind)
    B, S, D = args.batch_size, args.cache_slots, args.head_dim
    bound, bound_by, nbytes = decode_bound_ms(
        B, S, Hkv, args.n_head // Hkv, D, k.element_size(), q.element_size(),
        args.kv_quant, peak_bw, peak_ops)
    return {
        "metric": "decode_attention_chain_ms",
        "value": min(r["chain_ms"] for r in results.values()),
        "unit": "ms",
        "results": results,
        "bound_chain_ms": bound * L,
        "bound_by": bound_by,
        "bytes_per_layer": nbytes,
        "shape": {"L": L, "B": B, "S": S, "Hq": args.n_head, "Hkv": Hkv, "D": D},
        "kv_quant": bool(args.kv_quant),
        "cache_dtype": str(k.dtype).removeprefix("torch."),
        "block_s": args.block_s,
        "card": kind,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("benchmark_decode_kernel needs a CUDA device")
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
