#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports the port (``genomics_lm_torch``) and never JAX, and runs these
phases, each printing its findings on its own line; any failure raises and
exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``), CUDA version.
2. build   — compiles every kernel of the serving path from ``csrc/`` with
   nvcc for sm_90a (one nvcc per source, all started together).
3. kernel  — each kernel against its plain PyTorch version on the card at
   the serving shapes (bf16 and int8 caches, MHA and GQA, off-grid and
   unvectorizable shapes), then the kernel's time beside its bound, the
   plain version's time and one library call's time.
4. serve   — the main path: ``ServingEngine`` at the full width of the
   10L8H d384 CodonGPT (block 512, bf16, fused QKV, random weights from a
   seed) drains 128 requests; every kernel's launch count is reset just
   before and read just after, and must match the decode steps. One more
   drain runs the int8 KV cache.
5. parity  — a 2-layer float32 model gives identical greedy tokens on the
   card (kernel) and on the CPU (plain path).
6. http    — ``InferenceServer`` answers /generate (plain and streamed)
   and /stats on an ephemeral localhost port.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's measured numbers; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA it prints no result and exits 1.
"""

from __future__ import annotations

import copy
import http.client
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from genomics_lm_torch.kernels.build import CSRC, build
from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops import decode_attention as da
from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.serving.profile_drain import ENGINE, MAIN, REQUESTS, build_requests
from genomics_lm_torch.serving.server import InferenceServer

KERNEL_SOURCES = ["decode_attention"]

# Published peaks of the cards this runs on (NVIDIA data sheets, dense):
# device-memory bytes/s and bf16 tensor-core operations/s.
PEAKS = {
    "H100 PCIE": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100": (3.35e12, 989e12),
    "H200": (4.8e12, 989e12),
}

KERNEL_ATOL = 1e-3
KERNEL_ATOL_REASON = (
    "both sides read the same rounded operands (bf16, f32 or int8 with f32 "
    "scales) and accumulate in f32, so only the order of the sums differs "
    "(~1e-6 on outputs of order 1); an indexing or masking fault moves an "
    "output by order 1")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def card_peaks(name: str) -> tuple[float, float]:
    upper = name.upper()
    for key, peaks in PEAKS.items():  # most specific names first
        if key in upper:
            return peaks
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def median_ms(fn, runs: int = 25, warmup: int = 3, queued: bool = True) -> float:
    """Median over ``runs`` CUDA-event-timed calls of ``fn`` (after warm-up).

    ``queued``: each run is enqueued behind a spin of the device, so its
    launches run back to back and the time is the device's alone (the run
    is repeated with a longer spin if the device reached it before the host
    had enqueued all of it). Without it the time is paced by the host's
    per-call overhead, as eager serving sees it.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 40_000_000  # cycles, about 20 ms
    times = []
    while len(times) < runs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        if queued and start.query():  # the device caught up with the host
            if spin > 1 << 34:
                raise RuntimeError("the device keeps catching up: fn synchronizes")
            spin *= 2
            torch.cuda.synchronize()
            continue
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --- phase 2: build ------------------------------------------------------------


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build(KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    for name, lib in paths.items():
        report = lib.with_name(lib.name + ".log")
        text = report.read_text() if report.exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
        log("build", kernel=name, source=str((CSRC / f"{name}.cu").name),
            seconds=round(seconds, 2), instantiations=len(regs),
            max_registers=max(regs, default=None),
            spill_store_bytes=sum(spills))


# --- phase 3: the kernel against its plain version ------------------------------


def make_case(gen, L, B, S, Hkv, G, D, cache_dtype, q_dtype):
    """Random packed caches, query and a ragged same-segment mask on the card."""
    dev = "cuda"
    P = Hkv * D
    ks = vs = None
    if cache_dtype == torch.int8:
        k = torch.randint(-127, 128, (L, B, S, P), generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (L, B, S, P), generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.02
        vs = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.02
    else:
        k = torch.randn((L, B, S, P), generator=gen, device=dev).to(cache_dtype)
        v = torch.randn((L, B, S, P), generator=gen, device=dev).to(cache_dtype)
    q = torch.randn((B, Hkv * G, D), generator=gen, device=dev).to(q_dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    pos = torch.arange(S, device=dev)[None, :]
    valid = pos < lengths[:, None]
    valid[0, : S // 3] = False  # a segment boundary in row 0 ...
    valid[0, S // 2] = True     # ... with the self slot still attendable
    mask = torch.zeros((B, S), device=dev).masked_fill_(~valid, da.NEG_INF)
    return q, k, v, mask, ks, vs


def bound_ms(B, S, Hkv, G, D, esize, q_esize, quant, peak_bw, peak_ops):
    """Least time for one launch: bytes each read or written once over the
    memory rate, or the operations over the bf16 peak, whichever is larger."""
    P = Hkv * D
    Hq = Hkv * G
    nbytes = (2 * B * S * P * esize + B * Hq * D * q_esize + B * S * 4
              + B * Hq * D * 4 + (2 * B * Hkv * S * 4 if quant else 0))
    ops = 4 * B * Hq * S * D  # q·k and p·v, a multiply and an add each
    t_bytes, t_ops = nbytes / peak_bw * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def phase_kernel(peak_bw, peak_ops) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, L, B, S, Hkv, G, D, cache dtype, q dtype, timed
        ("main_bf16", 10, 64, 256, 8, 1, 48, bf16, bf16, True),
        ("main_int8", 10, 64, 256, 8, 1, 48, torch.int8, bf16, True),
        ("gqa4_bf16", 4, 64, 256, 2, 4, 48, bf16, bf16, False),
        ("gqa4_int8", 4, 64, 256, 2, 4, 48, torch.int8, bf16, False),
        ("g8_d64_bf16", 2, 16, 512, 1, 8, 64, bf16, bf16, False),
        ("offgrid_f32_d16", 2, 5, 130, 4, 2, 16, f32, f32, False),
        ("offgrid_bf16", 2, 5, 130, 8, 1, 48, bf16, bf16, False),
        ("scalar_loads_d20", 2, 3, 77, 2, 2, 20, bf16, bf16, False),
        ("int8_f32_query", 2, 5, 130, 2, 2, 48, torch.int8, f32, False),
    ]
    timed = {}
    for name, L, B, S, Hkv, G, D, cdt, qdt, is_timed in cases:
        q, k, v, mask, ks, vs = make_case(gen, L, B, S, Hkv, G, D, cdt, qdt)
        err = 0.0
        for layer in range(L):
            got = da.decode_attention(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)
            want = da.decode_attention_reference(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name}: non-finite kernel output")
            err = max(err, float((got - want).abs().max()))
        log("kernel", case=name, shape=dict(L=L, B=B, S=S, Hkv=Hkv, Hq=Hkv * G, D=D),
            cache=str(cdt).removeprefix("torch."), max_abs_err=err, tol=KERNEL_ATOL,
            tol_reason=KERNEL_ATOL_REASON)
        if err > KERNEL_ATOL:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({err} > {KERNEL_ATOL})")
        if not is_timed:
            continue
        # one timed run sweeps all L layers (250 MB of bf16 cache at the main
        # shape, 5x the 50 MB L2), so every launch reads its layer cold
        quant = ks is not None

        def sweep_kernel():
            for layer in range(L):
                da.decode_attention(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)

        def sweep_plain():
            for layer in range(L):
                da.decode_attention_reference(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)

        kernel_ms = median_ms(sweep_kernel) / L
        host_paced_ms = median_ms(sweep_kernel, queued=False) / L
        plain_ms = median_ms(sweep_plain) / L
        library_ms = None
        if not quant:
            q4 = q[:, :, None, :]
            am = mask[:, None, None, :].to(q.dtype)

            def sweep_library():
                for layer in range(L):
                    kl = k[layer].view(B, S, Hkv, D).transpose(1, 2)
                    vl = v[layer].view(B, S, Hkv, D).transpose(1, 2)
                    torch.nn.functional.scaled_dot_product_attention(
                        q4, kl, vl, attn_mask=am, enable_gqa=True)

            library_ms = median_ms(sweep_library) / L
        b_ms, b_by, nbytes = bound_ms(B, S, Hkv, G, D, k.element_size(),
                                      q.element_size(), quant, peak_bw, peak_ops)
        timed[name] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=library_ms, max_abs_err=err)
        log("kernel_time", case=name, bytes=nbytes, **timed[name],
            host_paced_ms=host_paced_ms,
            achieved_gb_per_s=nbytes / (kernel_ms * 1e-3) / 1e9,
            roofline_share=b_ms / kernel_ms)
    return timed


# --- phase 4: the main serving path ---------------------------------------------


def drain(model, cfg, reqs, kv_quant, seed=0):
    """Serve ``reqs`` to completion; returns (results, seconds, engine)."""
    eng = ServingEngine(model, cfg, **ENGINE, kv_quant=kv_quant, seed=seed, device="cuda")
    rids = [eng.submit(p, b, temperature=t) for p, b, t in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for rid, (_, budget, _) in zip(rids, reqs):
        toks = results[rid].tokens
        if len(toks) != budget or results[rid].finish_reason != "length":
            raise AssertionError(f"request {rid}: {len(toks)} tokens of {budget}, "
                                 f"finish {results[rid].finish_reason!r}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: token outside the vocabulary")
    return results, seconds, eng


def phase_serve(card: str) -> dict:
    cfg = CodonGPTConfig(**MAIN)
    torch.manual_seed(0)
    model = CodonGPT(cfg).to("cuda").eval()
    rng = np.random.default_rng(0)
    drain(model, cfg, build_requests(rng, 8), kv_quant=False)  # warm-up: cuBLAS, allocator
    reqs = build_requests(rng, REQUESTS)
    counts = {}
    for kv_quant in (False, True):
        torch.cuda.reset_peak_memory_stats()
        da.decode_attention.launches = 0  # the count of the main path's run only
        results, seconds, eng = drain(model, cfg, reqs, kv_quant)
        launches = da.decode_attention.launches
        steps = eng.stats()["decode_steps"]
        if launches == 0 or launches != cfg.n_layer * steps:
            raise AssertionError(f"kernel launches {launches} != n_layer x decode steps "
                                 f"({cfg.n_layer} x {steps})")
        delivered = sum(len(r.tokens) for r in results.values())
        counts[kv_quant] = launches
        log("serve", model="10L8H d384 bf16 fused_qkv", kv_quant=kv_quant,
            requests=len(reqs), slots=ENGINE["slots"],
            steps_per_sync=ENGINE["steps_per_sync"],
            delivered_tokens=delivered, seconds=seconds,
            delivered_tokens_per_s=delivered / seconds, decode_steps=steps,
            kernel_launches=launches,
            ms_per_decode_step=seconds * 1e3 / steps,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
    return {"model": model, "cfg": cfg, "launches": counts[False],
            "launches_int8": counts[True]}


# --- phase 5: the card against the CPU ------------------------------------------


def phase_parity() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CodonGPTConfig(**dict(MAIN, n_layer=2, block_size=256, compute_dtype="float32"))
    torch.manual_seed(1)
    cpu_model = CodonGPT(cfg).eval()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(1)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, n)], 24) for n in (9, 23, 40, 17)]
    reqs[1][0][7] = 3  # a <SEP> inside one prompt

    def tokens(model, device):
        eng = ServingEngine(model, cfg, slots=4, max_seq_len=128, steps_per_sync=8,
                            device=device)
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    before = da.decode_attention.launches
    on_card, on_cpu = tokens(gpu_model, "cuda"), tokens(cpu_model, "cpu")
    launched = da.decode_attention.launches - before
    same = on_card == on_cpu
    log("parity", model="2L8H d384 f32", prompts=len(reqs), identical_tokens=same,
        kernel_launches=launched)
    if not same or launched == 0:
        raise AssertionError("greedy tokens differ between the card and the CPU")


# --- phase 6: HTTP ---------------------------------------------------------------


def phase_http(model, cfg) -> None:
    eng = ServingEngine(model, cfg, **ENGINE, device="cuda")
    server = InferenceServer(eng, host="127.0.0.1", port=0)
    server.start()
    try:
        def call(method, path, body=None):
            conn = http.client.HTTPConnection(*server.address, timeout=120)
            try:
                conn.request(method, path, None if body is None else json.dumps(body),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        prompt = [1] + list(range(10, 40))
        replies = []
        for body in ({"prompt": prompt, "max_new_tokens": 20},
                     {"dna": "ATGGCTAGCAAAGGAGAAGAACTT", "max_new_tokens": 12,
                      "temperature": 1.0},
                     {"prompt": prompt, "max_new_tokens": 20, "stream": True}):
            status, raw = call("POST", "/generate", body)
            if status != 200:
                raise AssertionError(f"/generate answered {status}: {raw[:200]!r}")
            if body.get("stream"):
                events = [json.loads(x) for x in raw.decode().splitlines() if x.strip()]
                toks = sum((e["tokens"] for e in events), [])
                reason = events[-1]["finish_reason"]
            else:
                reply = json.loads(raw)
                toks, reason = reply["tokens"], reply["finish_reason"]
            if len(toks) != body["max_new_tokens"] or reason != "length":
                raise AssertionError(f"/generate gave {len(toks)} tokens, finish {reason!r}")
            replies.append(toks)
        if replies[0] != replies[2]:
            raise AssertionError("streamed greedy reply differs from the whole reply")
        status, raw = call("GET", "/stats")
        stats = json.loads(raw)
        if status != 200 or stats["completed"] != 3:
            raise AssertionError(f"/stats answered {status}: {stats}")
        log("http", requests=3, streamed=1, stats_completed=stats["completed"])
    finally:
        server.stop()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card_line = smi.splitlines()[0]
    print(card_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    peak_bw, peak_ops = card_peaks(kind)
    log("device", kind=kind, count=count, torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=card_line, peak_bytes_per_s=peak_bw,
        peak_bf16_ops_per_s=peak_ops)

    phase_build()
    timed = phase_kernel(peak_bw, peak_ops)
    served = phase_serve(card_line)
    phase_parity()
    phase_http(served["model"], served["cfg"])

    main_bf16, main_int8 = timed["main_bf16"], timed["main_int8"]
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "genomics_lm_torch/csrc/decode_attention.cu",
        "replaces": "genomics_lm_tpu/ops/decode_attention.py:207",
        "launches": served["launches"],
        **main_bf16,
        "int8": dict(main_int8, launches=served["launches_int8"]),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
