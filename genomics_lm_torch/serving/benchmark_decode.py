"""Whole-generation decode throughput: batched cached generation from a
prompt (twin of ``scripts/benchmark_decode.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.serving.benchmark_decode [--mode scan|stepwise] \\
        [--donate_cache] [--int8_weights] [--kv_quant] [--attention_impl xla|flash] \\
        [--speculative K] [--temperature 1.0] [--decode_tokens 128] \\
        [--measure_rounds 3] [--out report.json] [--device cpu]

The model is the script's, with random weights from a seed: 10L8H d384,
block 512, ``<SEP>`` id 3; on the card bfloat16, fused QKV and the decode
kernel (``attention_impl`` flash), on the CPU float32 and the plain path,
as JAX picks by backend. B 64 prompts of 64 random codons from
``default_rng(0)``. ``scan`` is ``generation/decode.py::generate_tokens``
(a loop of cached steps where JAX compiles one ``lax.scan``); ``stepwise``
is ``prefill`` then ``decode_step`` with ``sample_categorical`` (argmax at
temperature 0); ``--speculative K`` fits a bigram draft table to a stream
the model samples at temperature 1.0 and times
``serving/speculative.py::generate_tokens_speculative``. The prompt's
attention is the plain path in every mode, as in JAX's ``prefill``.
One warm run, then ``measure_rounds`` runs queued behind one another and
one sync; the speculative statistics are those of the last run, read after
the timed loop. Prints (and with ``--out`` writes) the script's report.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

METRIC = "decode_codon_tokens_per_sec_per_chip"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_layer", type=int, default=10)
    ap.add_argument("--n_head", type=int, default=8)
    ap.add_argument("--n_embd", type=int, default=384)
    ap.add_argument("--block_size", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--prefill_len", type=int, default=64)
    ap.add_argument("--decode_tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--measure_rounds", type=int, default=3)
    ap.add_argument("--mode", choices=["stepwise", "scan"], default="scan",
                    help="scan = the whole generation in one call (generate_tokens)")
    ap.add_argument("--donate_cache", action="store_true",
                    help="accepted for the JAX script's flag set; changes nothing here: "
                         "decode_step already updates the cache in place")
    ap.add_argument("--int8_weights", action="store_true",
                    help="weight-only int8 block linears (ops/quant.py)")
    ap.add_argument("--kv_quant", action="store_true",
                    help="int8 KV cache with per-vector scales")
    ap.add_argument("--attention_impl", choices=["xla", "flash"], default=None,
                    help="decode attention path: the CUDA decode kernel ('flash', the "
                         "card's default) or the plain version ('xla')")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decoding with K bigram-drafted tokens per verify "
                         "round (serving/speculative.py); the draft table is fitted to a "
                         "stream sampled from the model itself")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def build_model(args, device: torch.device):
    """(model, cfg) of the script: random weights from seed 0, int8 block
    linears under ``--int8_weights``."""
    from genomics_lm_torch.models.codon_gpt import CodonGPT
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.ops.quant import quantize_params

    on_card = device.type == "cuda"
    cfg = CodonGPTConfig(
        vocab_size=68, block_size=args.block_size, n_layer=args.n_layer,
        n_head=args.n_head, n_embd=args.n_embd, dropout=0.0, sep_id=3,
        compute_dtype="bfloat16" if on_card else "float32",
        fused_qkv=on_card,
        attention_impl=args.attention_impl or ("flash" if on_card else "xla"),
    )
    torch.manual_seed(0)
    model = CodonGPT(cfg).to(device).eval()
    if args.int8_weights:
        model = quantize_params(model)
    return model, cfg


def make_prompt(args) -> np.ndarray:
    """(B, P) random codon prompts from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return rng.integers(4, 68, (args.batch_size, args.prefill_len)).astype(np.int32)


def fit_draft_table(model, cfg, prompt, args, device) -> np.ndarray:
    """The script's draft table: bigrams of a stream the model samples at
    temperature 1.0 from the first (up to) 8 prompts (seed 42)."""
    from genomics_lm_torch.generation.decode import generate_tokens
    from genomics_lm_torch.serving.speculative import fit_bigram_table

    n = min(256, args.block_size - args.prefill_len)
    stream = generate_tokens(model, cfg, prompt[: min(8, len(prompt))], n,
                             torch.Generator(device=device).manual_seed(42), 1.0,
                             args.kv_quant, device=device).cpu().numpy()
    return fit_bigram_table([row for row in stream], cfg.vocab_size)


def make_run_once(model, cfg, prompt, args, device, table=None, spec_stats=None):
    """``run_once(seed)`` -> the (B, decode_tokens) generated ids of one run
    in ``args.mode`` (speculative with ``table`` when ``args.speculative``);
    a speculative run leaves (row-rounds, emitted) in ``spec_stats["_last"]``."""
    from genomics_lm_torch.generation.decode import (
        decode_step,
        generate_tokens,
        prefill,
        sample_categorical,
    )
    from genomics_lm_torch.serving.speculative import generate_tokens_speculative

    prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long).to(device)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    if args.speculative:
        def run_once(seed):
            toks, row_rounds, emitted = generate_tokens_speculative(
                model, cfg, prompt_t, args.decode_tokens, generator(seed), table,
                args.speculative, args.temperature, args.kv_quant, device=device)
            if spec_stats is not None:
                spec_stats["_last"] = (row_rounds, emitted)
            return toks
    elif args.mode == "scan":
        def run_once(seed):
            return generate_tokens(model, cfg, prompt_t, args.decode_tokens, generator(seed),
                                   args.temperature, args.kv_quant, device=device)
    else:
        @torch.no_grad()
        def run_once(seed):
            gen = generator(seed)
            logits, cache, _ = prefill(model, cfg, prompt_t, None, args.kv_quant,
                                       device=device)
            tokens = []
            for _ in range(args.decode_tokens):
                if args.temperature <= 0:
                    token = torch.argmax(logits, -1)
                else:
                    token = sample_categorical(logits.float() / args.temperature, gen)
                tokens.append(token)
                logits, cache, _ = decode_step(model, cfg, cache, token)
            return torch.stack(tokens, 1)
    return run_once


def run(args) -> dict:
    """Build, warm, time; the script's report."""
    from genomics_lm_torch.utils.device import resolve_device
    from genomics_lm_torch.utils.sync import hard_sync

    if args.speculative and args.mode != "scan":
        raise SystemExit("--speculative implies its own whole-program path; "
                         "it cannot combine with --mode stepwise")
    device = resolve_device(args.device)
    model, cfg = build_model(args, device)
    prompt = make_prompt(args)
    table = fit_draft_table(model, cfg, prompt, args, device) if args.speculative else None
    spec_stats: dict = {}
    run_once = make_run_once(model, cfg, prompt, args, device, table, spec_stats)

    hard_sync(run_once(1))  # warm: the kernels' build, cuBLAS handles, the allocator
    t0 = time.perf_counter()
    for round_idx in range(args.measure_rounds):
        out = run_once(2 + round_idx)
    hard_sync(out)
    elapsed = time.perf_counter() - t0

    if args.speculative and "_last" in spec_stats:
        row_rounds, emitted = (int(v) for v in spec_stats.pop("_last"))
        spec_stats["accept_rate"] = (
            (emitted - row_rounds) / max(1, row_rounds * args.speculative))
        spec_stats["tokens_per_round"] = emitted / max(1, row_rounds)

    B = args.batch_size
    generated = B * args.decode_tokens * args.measure_rounds
    report = {
        "metric": METRIC,
        "value": round(generated / elapsed, 1),
        "unit": "tokens/sec",
        "batch_size": B,
        "prefill_len": args.prefill_len,
        "decode_tokens": args.decode_tokens,
        "ms_per_decode_step": round(
            elapsed / (args.decode_tokens * args.measure_rounds) * 1000, 3),
        "mode": "speculative" if args.speculative else args.mode,
        "model": f"{args.n_layer}L{args.n_head}H d{args.n_embd}",
        "int8_weights": bool(args.int8_weights),
        "kv_quant": bool(args.kv_quant),
        "attention_impl": cfg.attention_impl,
    }
    if args.speculative:
        report["speculative_k"] = args.speculative
        report["accept_rate"] = round(spec_stats.get("accept_rate", 0.0), 4)
        report["tokens_per_round"] = round(spec_stats.get("tokens_per_round", 0.0), 3)
    return report


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
