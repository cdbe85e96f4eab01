#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports the port (``genomics_lm_torch``) and never JAX, and runs these
phases, each printing its findings on its own line; any failure raises and
exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``), CUDA version.
2. build   — compiles every kernel of the serving and training paths from
   ``csrc/`` with nvcc for sm_90a (one nvcc per source, all started
   together).
3. kernel  — the decode-attention kernel against its plain PyTorch version
   on the card at the serving shapes (bf16 and int8 caches, MHA and GQA,
   off-grid and unvectorizable shapes), then its time beside its bound,
   the plain version's time and one library call's time.
4. serve   — the serving main path: ``ServingEngine`` at the full width of
   the 10L8H d384 CodonGPT (block 512, bf16, fused QKV, random weights
   from a seed) drains 128 requests; the decode kernel's launch count is
   reset just before and read just after, and must match the decode
   steps. One more drain runs the int8 KV cache.
5. parity  — a 2-layer float32 model gives identical greedy tokens on the
   card (kernel) and on the CPU (plain path).
6. http    — ``InferenceServer`` answers /generate (plain and streamed)
   and /stats on an ephemeral localhost port.
7. flash   — the flash-attention forward, dQ and dK/dV kernels against
   their plain versions (O, LSE, and the gradients of a fixed cotangent)
   at the training shape with and without dropout, GQA, a window, suffix
   queries, an off-grid length, and float32 with and without the causal
   mask; then each kernel's time beside its bound, its plain version's
   time and one library call's.
8. train   — the training main path (``training/profile_step.py``): the
   same CodonGPT with dropout 0.1 and label smoothing, AdamW in two LR
   groups, 3 warm-up and 10 measured groups of 16 x 8 x 512 tokens; every
   loss finite, every group applied, and each flash kernel's launch count,
   reset just before the measured groups and read just after, equal to
   16 microbatches x 10 layers x 10 groups.
9. train parity — a 2-layer float32 model takes one group step on the
   card (kernels) and on the CPU (plain versions) from the same weights
   and batch; loss, gradients and updated parameters agree.

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
from genomics_lm_torch.ops import flash_attention as fa
from genomics_lm_torch.ops.masks import structure_mask
from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.serving.profile_drain import ENGINE, MAIN, REQUESTS, build_requests
from genomics_lm_torch.serving.server import InferenceServer
from genomics_lm_torch.training import profile_step as train_main
from genomics_lm_torch.training.optim import build_optimizer
from genomics_lm_torch.training.train_step import LossConfig, make_train_step

KERNEL_SOURCES = ["decode_attention", "flash_attention"]

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

# Flash kernels: error over max(1, max |plain|) of each output.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
FLASH_TOL_REASON = (
    "kernel and plain version read the same rounded operands and the same Philox "
    "keep bits and accumulate in float32, so only the order of the sums differs "
    "(~1e-6 relative); bf16 outputs may then round to neighbouring bf16 values, "
    "which are up to 2^-7 apart relative to the entry; a fault of indexing, "
    "masking or keep bits moves entries by much more (the float32 case, at "
    "1e-4, sees a single flipped keep bit)")
# Card-vs-CPU step: both sides run float32 (TF32 off) and differ only in the
# order of their sums, so loss and gradients are held tightly. Adam's first
# step moves an element by lr * g / (|g| + eps) with lr = 3e-4 whatever the
# gradient's size. Where |g| is far above eps the step is lr * sign(g) on both
# sides, so those parameters are held to param_atol. Where the gradient is
# near rounding level (the key bias, whose gradient is zero in exact
# arithmetic since softmax ignores a score shift shared by all keys, and the
# smallest entries of other leaves) the step follows the rounding noise and
# may take any value up to lr; parameters whose CPU gradient is below
# noise_grad_share of the model's largest are held to half a step, which a
# missing, doubled or sign-flipped update still exceeds. The log names the
# leaf that sets each error.
TRAIN_PARITY_TOL = dict(loss_rtol=1e-5, grad_rtol=1e-4, param_atol=3e-5,
                        noise_grad_share=1e-3, noise_param_atol=1.5e-4)


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


# --- phase 7: the flash kernels against their plain versions ---------------------


def flash_case(gen, B, Hq, Hkv, T, S, D, dtype, window, rate, causal=True):
    """Random q, k, v, <SEP>-segment ids (every 97th token), seed, config."""
    dev = "cuda"
    q = torch.randn((B, Hq, T, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    seps = (torch.arange(S, device=dev) % 97 == 0).to(torch.int32)
    seg = torch.cumsum(seps[None, :].expand(B, S), dim=-1, dtype=torch.int32).contiguous()
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    return q, k, v, seg, seed, fa.FlashCfg(causal, window, rate)


def flash_bounds(q, k, seg, cfg, peak_bw, peak_ops):
    """Least time of each kernel at these inputs: each input read once and
    each output written once over the memory rate, or the operations (a
    multiply and an add each) of the attended (query, key) pairs over the
    bf16 peak, whichever is larger. Per pair: q.k and p.v (4 D operations)
    forward; q.k, dO.v and dS.k (6 D) for dQ; q.k, dO.v, P^T.dO and dS^T.q
    (8 D) for dK/dV."""
    B, Hq, T, D = q.shape
    S = k.shape[2]
    pairs = int(structure_mask(T, S, causal=cfg.causal, window=cfg.window, segment_ids=seg,
                               device=q.device).sum()) * Hq
    e = q.element_size()
    qbytes, kvbytes = q.numel() * e, k.numel() * e
    rows, ids = B * Hq * T * 4, B * S * 4
    work = {  # name: (bytes, operations)
        "fwd": (2 * qbytes + 2 * kvbytes + rows + ids, 4 * D * pairs),
        "dq": (3 * qbytes + 2 * kvbytes + 2 * rows + ids, 6 * D * pairs),
        "dkv": (2 * qbytes + 4 * kvbytes + 2 * rows + ids, 8 * D * pairs),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / peak_bw * 1e3, ops / peak_ops * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, operations=ops)
    return out, pairs


def phase_flash(peak_bw, peak_ops) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    width = train_main.MAIN_TRAIN
    B, H, T, D = train_main.B, width["n_head"], train_main.T, width["n_embd"] // width["n_head"]
    cases = [
        # name, B, Hq, Hkv, T, S, D, dtype, window, dropout, timed
        ("main_bf16", B, H, H, T, T, D, bf16, None, 0.0, False),
        ("main_bf16_dropout", B, H, H, T, T, D, bf16, None, 0.1, True),
        ("gqa_bf16", B, H, 2, T, T, D, bf16, None, 0.1, False),
        ("window64_bf16", B, H, H, T, T, D, bf16, 64, 0.1, False),
        ("suffix_bf16", B, H, H, 128, T, D, bf16, None, 0.1, False),
        ("offgrid_bf16", B, H, H, 130, 130, D, bf16, None, 0.1, False),
        ("f32_gqa_window_d20", 2, 4, 2, 200, 333, 20, f32, 50, 0.1, False),
        ("f32_noncausal_d64", 2, 4, 4, 150, 150, 64, f32, None, 0.1, False),
    ]
    timed = {}
    for name, b, hq, hkv, t, s_len, d, dtype, window, rate, is_timed in cases:
        causal = "noncausal" not in name
        q, k, v, seg, seed, cfg = flash_case(gen, b, hq, hkv, t, s_len, d, dtype, window, rate,
                                             causal)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(qg, kg, vg, segment_ids=seg, attention_window=window,
                                 dropout_rate=rate, seed=seed, causal=causal)
        cot = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        grads = torch.autograd.grad(out, (qg, kg, vg), cot)
        _, lse = fa.flash_fwd(q, k, v, seg, seed, cfg)
        want_out, want_lse = fa.flash_forward_reference(q, k, v, seg, seed, cfg)
        delta = (cot.float() * out.detach().float()).sum(dim=-1)
        want = [fa.flash_bwd_dq_reference(q, k, v, seg, seed, cot, want_lse, delta, cfg),
                *fa.flash_bwd_dkv_reference(q, k, v, seg, seed, cot, want_lse, delta, cfg)]
        torch.cuda.synchronize()
        errs, abs_errs = {}, {}
        for key, got, ref in zip(("out", "lse", "dq", "dk", "dv"),
                                 (out.detach(), lse, *grads), (want_out, want_lse, *want)):
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash {name}: non-finite {key}")
            abs_errs[key] = float((got.float() - ref.float()).abs().max())
            errs[key] = abs_errs[key] / max(1.0, float(ref.float().abs().max()))
        tol = FLASH_TOL[dtype]
        log("flash", case=name, shape=dict(B=b, Hq=hq, Hkv=hkv, T=t, S=s_len, D=d),
            dtype=str(dtype).removeprefix("torch."), causal=causal, window=window,
            dropout=rate,
            rel_err=errs, max_abs_err=abs_errs, tol=tol, tol_reason=FLASH_TOL_REASON)
        if max(errs.values()) > tol:
            raise AssertionError(f"flash {name}: kernel disagrees with its plain version "
                                 f"({errs} > {tol})")
        if not is_timed:
            continue
        bounds, pairs = flash_bounds(q, k, seg, cfg, peak_bw, peak_ops)
        dout = cot.contiguous()
        kernel = {
            "fwd": lambda: fa.flash_fwd(q, k, v, seg, seed, cfg),
            "dq": lambda: fa.flash_bwd_dq(q, k, v, seg, seed, dout, lse, delta, cfg),
            "dkv": lambda: fa.flash_bwd_dkv(q, k, v, seg, seed, dout, lse, delta, cfg),
        }
        plain = {
            "fwd": lambda: fa.flash_forward_reference(q, k, v, seg, seed, cfg),
            "dq": lambda: fa.flash_bwd_dq_reference(q, k, v, seg, seed, dout, lse, delta, cfg),
            "dkv": lambda: fa.flash_bwd_dkv_reference(q, k, v, seg, seed, dout, lse, delta,
                                                      cfg),
        }
        # the yardstick: SDPA with the dense boolean mask and the same dropout
        # rate (its own random stream); its backward computes dQ, dK and dV at
        # once, so that one time stands beside both backward kernels
        dense = structure_mask(t, s_len, causal=causal, window=window, segment_ids=seg,
                               device=q.device)
        ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=dense, dropout_p=rate)

        lib_out = sdpa()
        library = {"fwd": median_ms(sdpa, runs=15),
                   "bwd": median_ms(lambda: torch.autograd.grad(
                       lib_out, (ql, kl, vl), dout, retain_graph=True), runs=15)}
        err_of = {"fwd": max(abs_errs["out"], abs_errs["lse"]), "dq": abs_errs["dq"],
                  "dkv": max(abs_errs["dk"], abs_errs["dv"])}
        for key in ("fwd", "dq", "dkv"):
            ms = median_ms(kernel[key], runs=15)
            timed[key] = dict(ms=ms, plain_ms=median_ms(plain[key], runs=5),
                              bound_ms=bounds[key]["bound_ms"],
                              bound_by=bounds[key]["bound_by"],
                              library_ms=library["fwd" if key == "fwd" else "bwd"],
                              max_abs_err=err_of[key])
            log("flash_time", kernel=key, case=name, attended_pairs=pairs,
                bytes=bounds[key]["bytes"], operations=bounds[key]["operations"],
                **timed[key], roofline_share=bounds[key]["bound_ms"] / ms)
    return timed


# --- phase 8: the training main path ----------------------------------------------

FLASH_WRAPPERS = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)


def phase_train(card: str) -> dict:
    cfg, model, bundle, step = train_main.build_main("cuda")
    gen = torch.Generator(device="cuda").manual_seed(train_main.SEED)
    batches = [train_main.make_batch(s, "cuda") for s in range(train_main.BATCHES)]
    nonpad = int((batches[0]["y"] != 0).sum())
    warmup, measured = 3, 10
    train_main.run_groups(model, bundle, step, batches, gen, warmup)
    torch.cuda.reset_peak_memory_stats()
    for w in FLASH_WRAPPERS:
        w.launches = 0  # the count of the main path's measured run only
    seconds, metrics = train_main.run_groups(model, bundle, step, batches, gen, measured)
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    G = train_main.G
    losses = [float(m["total_loss_sum"]) / max(1, int(m["committed_microbatches"]))
              for m in metrics]
    applied = [bool(m["applied"]) for m in metrics]
    log("train", model="10L8H d384 bf16 fused_qkv dropout 0.1 flash", groups=measured,
        group_shape=[G, train_main.B, train_main.T], nonpad_tokens_per_group=nonpad,
        seconds=seconds, ms_per_group=seconds * 1e3 / measured,
        nonpad_tokens_per_s=nonpad * measured / seconds, losses=losses, applied=applied,
        kernel_launches=launches, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        card=card)
    want = G * cfg.n_layer * measured
    if any(n != want for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != G x n_layer x groups = {want}")
    if not all(applied) or not all(np.isfinite(losses)):
        raise AssertionError(f"a group failed: losses {losses}, applied {applied}")
    return launches


# --- phase 9: one group step on the card against the CPU -------------------------


def phase_train_parity() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CodonGPTConfig(**dict(train_main.MAIN_TRAIN, n_layer=2, dropout=0.0,
                                compute_dtype="float32"))
    torch.manual_seed(3)
    cpu_model = CodonGPT(cfg)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    step = make_train_step(cfg, LossConfig())
    run_cfg = dict(train_main.RUN_CFG, warmup_steps=0)  # the full lr, 3e-4
    batch = train_main.make_batch(7, "cpu", groups=2, batch=4)
    before = [w.launches for w in FLASH_WRAPPERS]
    results = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        bundle = build_optimizer(run_cfg, model, total_steps=train_main.TOTAL_STEPS)
        m = step(model, bundle, {k: t.to(dev) for k, t in batch.items()}, None, 1.0)
        results[dev] = (float(m["total_loss_sum"]), bool(m["applied"]),
                        {n: (p.detach().cpu(), p.grad.cpu()) for n, p in
                         model.named_parameters()})
    launched = [w.launches - b for w, b in zip(FLASH_WRAPPERS, before)]
    (loss_g, ok_g, gpu), (loss_c, ok_c, cpu) = results["cuda"], results["cpu"]
    tol = TRAIN_PARITY_TOL
    gmax = max(float(g.abs().max()) for _, g in cpu.values())
    grad_err = max(float((gpu[n][1] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * gmax)
                   for n, (_, g) in cpu.items())
    # (error, leaf, elements) of the parameters with a real gradient and of
    # those whose gradient is rounding noise
    worst = {"signal": (0.0, None, 0), "noise": (0.0, None, 0)}
    for n, (p, g) in cpu.items():
        noise = g.abs() < tol["noise_grad_share"] * gmax
        diff = (gpu[n][0] - p).abs()
        for key, sel in (("signal", ~noise), ("noise", noise)):
            count = int(sel.sum())
            err = float(diff[sel].max()) if count else 0.0
            best = worst[key]
            worst[key] = (max(err, best[0]), n if err > best[0] else best[1], best[2] + count)
    param_err, noise_err = worst["signal"][0], worst["noise"][0]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    log("train_parity", model="2L8H d384 f32", group_shape=[2, 4, train_main.T],
        loss_card=loss_g, loss_cpu=loss_c, loss_rel_err=loss_err, grad_rel_err=grad_err,
        param_abs_err=param_err, param_abs_err_leaf=worst["signal"][1],
        noise_param_abs_err=noise_err, noise_param_abs_err_leaf=worst["noise"][1],
        noise_elements=worst["noise"][2], signal_elements=worst["signal"][2],
        kernel_launches=launched, tol=tol)
    if not (ok_g and ok_c) or min(launched) == 0:
        raise AssertionError("the parity step was not applied or launched no kernel")
    if (loss_err > tol["loss_rtol"] or grad_err > tol["grad_rtol"]
            or param_err > tol["param_atol"] or noise_err > tol["noise_param_atol"]):
        raise AssertionError("the card's step disagrees with the CPU's")


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
    flash_timed = phase_flash(peak_bw, peak_ops)
    trained = phase_train(card_line)
    phase_train_parity()

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
    for key, wrapper, line in (("fwd", fa.flash_fwd, 206), ("dq", fa.flash_bwd_dq, 365),
                               ("dkv", fa.flash_bwd_dkv, 390)):
        kernels.append({
            "name": wrapper.__name__,
            "route": "cuda",
            "source": "genomics_lm_torch/csrc/flash_attention.cu",
            "replaces": f"genomics_lm_tpu/ops/flash_attention.py:{line}",
            "launches": trained[wrapper.__name__],
            **flash_timed[key],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
