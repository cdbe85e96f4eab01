"""Speculative decoding on a trained model (twin of ``scripts/benchmark_speculative.py``).

Speculation pays in proportion to how well the bigram draft predicts the
target model, which for random weights is near zero. So, as the JAX
script does:

1. synthesize a first-order-Markov codon corpus (``markov_windows``: the
   code of ``scripts/benchmark_speculative.py:47-67``, its transition matrix
   built by one helper that the entropy rate reads too);
2. train the model on it with the port's ``run_training`` (the JAX script's
   run config: bf16 and flash attention on the card);
3. fit the bigram draft table on the training tokens;
4. measure both decode protocols on the trained weights, loaded back from
   the run's ``best.npz``: the serving drain of ``ServingEngine`` with and
   without ``speculative_k`` (median of ``--repeats``), and offline
   ``generate_tokens`` against ``generate_tokens_speculative``.

It prints one JSON line with the JAX script's keys (throughputs, speedups,
the acceptance rate and tokens per round), plus the serving engine's
acceptance and tokens per slot-round, the chunk kernel's launches and the
verify rounds of the measured speculative drains, each protocol's cache
positions (the shapes its kernels ran at), and the validation loss
beside the chain's entropy rate (``markov_entropy_rate``, from its
transition matrix), which says how much of the chain the model learnt.
With ``--arrival_rate`` > 0 it also runs the open-loop Poisson latency
protocol (``utils/cli.py::poisson_latency_drain``) on both engines and
reports their TTFT and ITL percentiles, as the JAX script does.

    python -m genomics_lm_torch.serving.benchmark_speculative [--epochs 8] [--repeats 5]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.generation.decode import cache_bucket, generate_tokens
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops import decode_attention as da
from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.serving.speculative import (
    fit_bigram_table,
    generate_tokens_speculative,
    speculative_cache_size,
)
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training.checkpoints import load_checkpoint
from genomics_lm_torch.utils.cli import latency_percentiles, poisson_latency_drain
from genomics_lm_torch.training.loop import run_training
from genomics_lm_torch.utils.device import resolve_device
from genomics_lm_torch.utils.weights import params_from_jax


def _markov_transitions(rng, concentration, vocab) -> np.ndarray:
    """The chain's (vocab, vocab) transition matrix, from the first draws of
    ``rng``: four successors a state, Dirichlet weights over them, 1e-3
    everywhere else, rows normalized."""
    trans = np.full((vocab, vocab), 1e-3)
    for i in range(vocab):
        successors = rng.choice(vocab, 4, replace=False)
        trans[i, successors] = rng.dirichlet(np.ones(4) * concentration) * 10
    return trans / trans.sum(axis=1, keepdims=True)


def markov_windows(n, T, seed, concentration=0.5, vocab=64, offset=4):
    """Windows from a sparse random bigram chain over codon ids 4..67
    (the generator from tests/test_learning_dynamics.py)."""
    rng = np.random.default_rng(seed)
    trans = _markov_transitions(rng, concentration, vocab)
    X = np.zeros((n, T), np.int32)
    state = rng.integers(0, vocab, n)
    for t in range(T):
        X[:, t] = state + offset
        cum = trans[state].cumsum(axis=1)
        u = rng.random((n, 1))
        state = (u > cum).sum(axis=1)
    Y = np.roll(X, -1, axis=1)
    Y[:, -1] = 0
    return X, Y


def markov_transitions(seed, concentration=0.5, vocab=64) -> np.ndarray:
    """The transition matrix ``markov_windows`` draws its windows from."""
    return _markov_transitions(np.random.default_rng(seed), concentration, vocab)


def markov_entropy_rate(trans: np.ndarray) -> float:
    """H = -sum_i pi_i sum_j P_ij ln P_ij in nats, pi the stationary
    distribution: the least next-token loss a model of the chain can reach
    in the long run."""
    w, v = np.linalg.eig(trans.T)
    pi = np.real(v[:, np.argmin(np.abs(w - 1.0))])
    pi = pi / pi.sum()
    return float(-(pi[:, None] * trans * np.log(trans)).sum())


def load_trained(run_dir: Path, device, *, fused_qkv: bool):
    """(model on ``device``, cfg) from the run's ``best.npz``, dropout 0."""
    payload = load_checkpoint(run_dir / "checkpoints" / "best.npz")
    cfg_map = dict(payload["cfg"])
    cfg_map.setdefault("vocab_size", int(np.asarray(payload["model"]["tok_emb"]).shape[0]))
    cfg = CodonGPTConfig.from_run_config(cfg_map).replace(dropout=0.0, fused_qkv=fused_qkv)
    return params_from_jax(payload["model"], cfg, device), cfg, payload


def run(args, device=None) -> dict:
    """Train, then measure; the report ``main`` prints."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    T = args.block_size
    X, Y = markov_windows(args.train_windows + 64, T, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.savez(tmp / "train.npz", X=X[: args.train_windows], Y=Y[: args.train_windows])
        np.savez(tmp / "val.npz", X=X[args.train_windows:], Y=Y[args.train_windows:])
        write_itos(tmp / "itos.txt")
        cfg_d = dict(
            train_npz=str(tmp / "train.npz"), val_npz=str(tmp / "val.npz"),
            block_size=T, n_layer=args.n_layer, n_head=args.n_head,
            n_embd=args.n_embd, dropout=0.0, batch_size=16,
            grad_accum_steps=1, lr=3e-3, min_lr=3e-4, warmup_steps=20,
            epochs=args.epochs, seed=1337, run_id="spec-bench",
            early_stop_patience=0,
            compute_dtype="bfloat16" if on_card else "float32",
            attention_impl="flash" if on_card else "xla",
        )
        t_train0 = time.perf_counter()
        meta = run_training(cfg_d, run_root=str(tmp / "runs"), device=device,
                            progress_every=0)
        train_sec = time.perf_counter() - t_train0
        if meta["status"] != "completed":
            raise RuntimeError(f"training did not complete: {meta}")
        model, cfg, payload = load_trained(tmp / "runs" / "spec-bench", device,
                                           fused_qkv=on_card)

    table = fit_bigram_table(X[: args.train_windows], cfg.vocab_size)
    # prompts drawn from held-out chain windows (in-domain, like serving a
    # trained model on real sequences)
    prompts = X[args.train_windows:args.train_windows + args.batch_size,
                : args.prefill_len].astype(np.int64)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn, seeds):
        fn(seeds[0])  # warm
        sync()
        t0 = time.perf_counter()
        out = [fn(s) for s in seeds[1:]]
        sync()
        return time.perf_counter() - t0, out[-1]

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    generated = args.batch_size * args.decode_tokens * args.measure_rounds
    plain_sec, _ = timed(
        lambda s: generate_tokens(model, cfg, prompts, args.decode_tokens, gen(s),
                                  args.temperature, args.kv_quant, device=device),
        [1] + [2 + i for i in range(args.measure_rounds)])
    spec_sec, out = timed(
        lambda s: generate_tokens_speculative(
            model, cfg, prompts, args.decode_tokens, gen(s), table, args.n_draft,
            args.temperature, args.kv_quant, device=device),
        [11] + [12 + i for i in range(args.measure_rounds)])
    plain_tps, spec_tps = generated / plain_sec, generated / spec_sec
    row_rounds, emitted = out[1], out[2]

    # the cache positions each protocol's kernels read (decode: plain;
    # chunk: speculative), so a check can run the kernels at the same shapes
    horizon = args.prefill_len + args.decode_tokens
    cache_positions = {"offline_plain": cache_bucket(cfg, horizon),
                       "offline_speculative": speculative_cache_size(horizon, args.n_draft)}
    serving = {}
    if args.serving_requests > 0:
        n_req = int(args.serving_requests)

        def mk_engine(spec: bool) -> ServingEngine:
            kw = dict(speculative_k=args.n_draft, draft_table=table) if spec else {}
            return ServingEngine(model, cfg, slots=args.batch_size,
                                 max_seq_len=args.prefill_len + args.decode_tokens,
                                 kv_quant=args.kv_quant, steps_per_sync=args.steps_per_sync,
                                 seed=7, device=device, **kw)

        def drain(spec: bool):
            def once(n):
                eng = mk_engine(spec)
                for i in range(n):
                    eng.submit([int(t) for t in prompts[i % len(prompts)]],
                               args.decode_tokens, temperature=args.temperature)
                t0 = time.perf_counter()
                results = eng.run()
                delivered = sum(len(r.tokens) for r in results.values())
                cache_positions[f"serving_{'speculative' if spec else 'plain'}"] = int(
                    eng.state["k"].shape[2])
                return delivered / (time.perf_counter() - t0), eng.stats()

            once(args.batch_size)  # warm
            before = da.decode_attention_chunk.launches
            runs = [once(n_req) for _ in range(max(1, args.repeats))]
            launches = da.decode_attention_chunk.launches - before
            return sorted(r[0] for r in runs), [r[1] for r in runs], launches

        def spread(xs):
            med = float(np.median(xs))
            return 100.0 * (xs[-1] - xs[0]) / med if med else 0.0

        plain, _, _ = drain(False)
        spec_s, spec_stats, chunk_launches = drain(True)
        serving = {
            "serving_plain_tok_per_sec": float(np.median(plain)),
            "serving_plain_samples": plain,
            "serving_plain_spread_pct": spread(plain),
            "serving_speculative_tok_per_sec": float(np.median(spec_s)),
            "serving_speculative_samples": spec_s,
            "serving_speculative_spread_pct": spread(spec_s),
            "serving_accept_rate": [s["speculative_accept_rate"] for s in spec_stats],
            "serving_tokens_per_slot_round": [s["speculative_tokens_per_round"]
                                              for s in spec_stats],
            "verify_rounds": sum(s["verify_rounds"] for s in spec_stats),
            "chunk_kernel_launches": chunk_launches,
        }
        serving["speedup_serving"] = (serving["serving_speculative_tok_per_sec"]
                                      / serving["serving_plain_tok_per_sec"])

        if args.arrival_rate > 0:
            def latency(spec: bool) -> dict:
                reqs = [([int(t) for t in prompts[i % len(prompts)]], args.decode_tokens,
                         args.temperature) for i in range(n_req)]
                warm = mk_engine(spec)
                for p, b, temp in reqs[: args.batch_size]:
                    warm.submit(p, b, temperature=temp)
                warm.run()
                ttft, itl, _, _ = poisson_latency_drain(
                    mk_engine(spec), reqs, args.arrival_rate, seed=args.seed)
                lat = latency_percentiles(ttft, itl)
                return {k: lat[k] for k in ("ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
                                            "itl_p95_ms")}

            serving["latency_plain"] = latency(False)
            serving["latency_speculative"] = latency(True)
            serving["arrival_rate_req_per_sec"] = args.arrival_rate

    val_loss = float(payload["val_loss"])
    return {
        "metric": "speculative_decode_tokens_per_sec_per_chip",
        "value": serving.get("serving_speculative_tok_per_sec", spec_tps),
        "unit": "tokens/sec",
        **serving,
        "offline_speculative_tok_per_sec": spec_tps,
        "offline_plain_tok_per_sec": plain_tps,
        "speedup_offline": spec_tps / plain_tps,
        "accept_rate": (emitted - row_rounds) / max(1, row_rounds * args.n_draft),
        "tokens_per_round": emitted / max(1, row_rounds),
        "n_draft": args.n_draft,
        "batch_size": args.batch_size,
        "decode_tokens": args.decode_tokens,
        "temperature": args.temperature,
        "kv_quant": bool(args.kv_quant),
        "n_layer": cfg.n_layer,
        "n_head": cfg.n_head,
        "kv_heads": cfg.kv_heads,
        "head_dim": cfg.head_dim,
        "cache_positions": cache_positions,
        "train_sec": train_sec,
        "val_loss": val_loss,
        "val_next_loss": float(payload["val_next_loss"]),
        "chain_entropy_rate_nats": markov_entropy_rate(markov_transitions(args.seed)),
        "model": f"{args.n_layer}L{args.n_head}H d{args.n_embd} (trained "
                 f"{args.epochs} epochs, {train_sec:.1f}s, val_loss {val_loss:.3f})",
        "device": str(device),
        "card": torch.cuda.get_device_name(device) if on_card else None,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_layer", type=int, default=4)
    ap.add_argument("--n_head", type=int, default=4)
    ap.add_argument("--n_embd", type=int, default=256)
    ap.add_argument("--block_size", type=int, default=256)
    ap.add_argument("--train_windows", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--prefill_len", type=int, default=64)
    ap.add_argument("--decode_tokens", type=int, default=128)
    ap.add_argument("--n_draft", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--kv_quant", action="store_true")
    ap.add_argument("--measure_rounds", type=int, default=3)
    ap.add_argument("--serving_requests", type=int, default=256,
                    help="requests per serving drain (0 skips the serving comparison)")
    ap.add_argument("--steps_per_sync", type=int, default=16,
                    help="decode rounds per dispatched serving chunk")
    ap.add_argument("--repeats", type=int, default=5, help="median-of-N serving drains")
    ap.add_argument("--arrival_rate", type=float, default=0.0,
                    help="also run the open-loop Poisson latency protocol at this "
                         "arrival rate (req/s) on both engines")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    report = run(args, args.device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
