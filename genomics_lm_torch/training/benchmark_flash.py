"""Time the three flash-attention kernels across batch, segment layout and
dropout, at the training path's head shape (8 heads of 48, T = S = 512, bf16).

The main path's case (B 8, a <SEP> every 97th token, dropout 0.1) beside
variants that change one thing each: no dropout, no segment ids (every tile
of the causal band is live), a segment every 4th token (only diagonal tiles
live), batch 1 (64 blocks: one partial wave, so the time is one block's
latency) and batch 32. Each line gives the tiles the three bf16 kernels
(forward, dQ and dK/dV alike) visit (``flash_live_tiles``) and each
kernel's median time queued behind a device spin. Needs a CUDA card:

    python -m genomics_lm_torch.training.benchmark_flash
"""

from __future__ import annotations

import json
import subprocess

import torch

from genomics_lm_torch.ops import flash_attention as fa
from genomics_lm_torch.utils.timing import median_ms

H, T, D = 8, 512, 48
CASES = [  # name, batch, <SEP> every (None: no ids), dropout
    ("main", 8, 97, 0.1),
    ("no_dropout", 8, 97, 0.0),
    ("no_segments", 8, None, 0.1),
    ("segments_of_4", 8, 4, 0.1),
    ("batch_1", 1, 97, 0.1),
    ("batch_32", 32, 97, 0.1),
]


def run_case(gen, B: int, every, rate: float) -> dict:
    """Median µs of each kernel on one case, and the tiles each bf16 kernel visits."""
    q, k, v = (torch.randn((B, H, T, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    seg = None
    if every is not None:
        seps = (torch.arange(T, device="cuda") % every == 0).to(torch.int32)
        seg = torch.cumsum(seps[None].expand(B, T), -1, dtype=torch.int32).contiguous()
    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    cfg = fa.FlashCfg(True, None, rate)
    out, lse = fa.flash_fwd(q, k, v, seg, seed, cfg)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1)
    live = fa.flash_live_tiles(seg, T, T)
    return {
        "tiles_visited": int(live.sum()) * H * (B if seg is None else 1),
        "band_tiles": int(fa.flash_live_tiles(None, T, T).sum()) * H * B,
        "fwd_us": 1e3 * median_ms(lambda: fa.flash_fwd(q, k, v, seg, seed, cfg), runs=15),
        "dq_us": 1e3 * median_ms(
            lambda: fa.flash_bwd_dq(q, k, v, seg, seed, dout, lse, delta, cfg), runs=15),
        "dkv_us": 1e3 * median_ms(
            lambda: fa.flash_bwd_dkv(q, k, v, seg, seed, dout, lse, delta, cfg), runs=15),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("benchmark_flash needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, B, every, rate in CASES:
        print(json.dumps({"case": name, "batch": B, "sep_every": every, "dropout": rate,
                          "shape": [B, H, T, D], **run_case(gen, B, every, rate),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
