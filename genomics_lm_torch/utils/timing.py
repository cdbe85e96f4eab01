"""Timing kernels on the card, and the least time the card could take.

``median_ms`` times a callable queued behind a spin of the device, so its
launches run back to back and the time is the device's alone (a plain
event-timed loop measures the host's per-call overhead instead).
``decode_bound_ms`` is the roofline of the decode-attention kernels: each
input byte read once and each output byte written once over the memory
rate, or their operations over the bf16 peak, whichever is larger. Used by
``chip_smoke.py`` and ``serving/benchmark_decode_kernel.py``; needs a CUDA
card to time anything.
"""

from __future__ import annotations

import statistics

import torch

# Published peaks of the cards this runs on (NVIDIA data sheets, dense):
# device-memory bytes/s and bf16 tensor-core operations/s.
PEAKS = {
    "H100 PCIE": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100": (3.35e12, 989e12),
    "H200": (4.8e12, 989e12),
}


def card_peaks(name: str) -> tuple[float, float]:
    """(bytes/s, bf16 operations/s) of the card named ``name``."""
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


def decode_bound_ms(B, S, Hkv, G, D, esize, q_esize, quant, peak_bw, peak_ops, T=1,
                    positions=None):
    """Least time of one decode-attention launch over one cache layer, with
    T queries per slot (T = 1: the single-token kernels; T > 1: the verify
    chunk, whose query, mask and output grow by T). ``positions``: the cache
    positions the work needs, summed over the slots (default every one,
    B * S); the whole mask is read either way.

    Returns (ms, "bytes" or "operations", bytes).
    """
    P = Hkv * D
    Hq = Hkv * G
    n = B * S if positions is None else int(positions)
    nbytes = (2 * n * P * esize + B * Hq * T * D * q_esize + B * T * S * 4
              + B * Hq * T * D * 4 + (2 * n * Hkv * 4 if quant else 0))
    ops = 4 * n * Hq * T * D  # q·k and p·v, a multiply and an add each
    t_bytes, t_ops = nbytes / peak_bw * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


__all__ = ["PEAKS", "card_peaks", "decode_bound_ms", "median_ms"]
