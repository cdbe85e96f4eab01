"""Command-line plumbing shared by the port's entry points: the port's own
copy of ``scripts/_shared.py``'s ``resolve_run_dir`` and
``poisson_latency_drain`` (the open-loop latency protocol of the serving
benchmarks)."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np


def resolve_run_dir(run_id: str, root: str | Path = "runs") -> Path:
    """Accept a run id under ``runs/`` or a direct path."""
    direct = Path(run_id)
    if direct.is_dir():
        return direct
    candidate = Path(root) / run_id
    if candidate.is_dir():
        return candidate
    raise FileNotFoundError(f"run directory not found: {run_id}")


def poisson_latency_drain(engine, requests, rate: float, *, seed: int = 0,
                          pipelined: bool = True):
    """Open-loop Poisson-arrival serving-latency protocol.

    ``requests``: list of (prompt ids, max_new_tokens, temperature);
    arrivals are exponential at ``rate`` req/s, latency counts from the
    scheduled arrival (a late submit is charged to TTFT as queueing delay).
    Returns (ttft seconds list, itl seconds list, delivered tokens, elapsed
    seconds): TTFT includes queueing, the admission prefill and the first
    decode chunk; ITL is the mean per-token spacing after the first delta,
    both at chunk granularity (what a streaming client observes).
    """
    if not requests:
        return [], [], 0, 0.0
    arr_rng = np.random.default_rng(seed + 7)
    gaps = arr_rng.exponential(1.0 / rate, len(requests))
    t0 = time.perf_counter()
    arrivals = np.cumsum(gaps) - gaps[0]
    it = iter(zip(requests, arrivals))
    nxt = next(it)
    t_submit, t_first, t_done, n_toks = {}, {}, {}, {}

    def submit_due():
        nonlocal nxt
        now = time.perf_counter() - t0
        while nxt is not None and nxt[1] <= now:
            (prompt, budget, temperature), arrival = nxt
            rid = engine.submit(prompt, budget, temperature=temperature)
            t_submit[rid] = t0 + arrival
            nxt = next(it, None)

    delivered = 0
    while nxt is not None or engine.pending or engine.n_active:
        submit_due()
        if not engine.pending and engine.n_active == 0:
            time.sleep(max(0.0, min(0.005, nxt[1] - (time.perf_counter() - t0))))
            continue
        for rid, toks, reason in engine.stream(pipelined=pipelined):
            now = time.perf_counter()
            t_first.setdefault(rid, now)
            n_toks[rid] = n_toks.get(rid, 0) + len(toks)
            delivered += len(toks)
            if reason:
                t_done[rid] = now
            submit_due()
    elapsed = time.perf_counter() - t0
    ttft = [t_first[r] - t_submit[r] for r in t_first]
    itl = [(t_done[r] - t_first[r]) / max(n_toks[r] - 1, 1)
           for r in t_done if n_toks.get(r, 0) > 1]
    return ttft, itl, delivered, elapsed


def latency_percentiles(ttft, itl) -> dict:
    """The report's TTFT and ITL percentiles in ms (one decimal, as the JAX
    scripts print them)."""
    pct = lambda xs, q: round(float(np.percentile(xs, q)) * 1e3, 1)  # noqa: E731
    return {"ttft_p50_ms": pct(ttft, 50), "ttft_p95_ms": pct(ttft, 95),
            "ttft_p99_ms": pct(ttft, 99), "itl_p50_ms": pct(itl, 50),
            "itl_p95_ms": pct(itl, 95)}


__all__ = ["latency_percentiles", "poisson_latency_drain", "resolve_run_dir"]
