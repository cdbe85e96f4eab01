"""Where a training group's time goes on the card.

Owns the training main path that ``chip_smoke.py`` drives, the step that
``bench.py`` defines (``bench.py:57-84,104-112``): the 10L8H d384
CodonGPT (block 512, ``<SEP>`` id 3, tied embeddings, fused QKV, bf16
compute with float32 master weights, dropout 0.1, label smoothing 0.05,
flash attention); AdamW in the fast and base groups, lr 3e-4, cosine over
5000 steps after 100 of warmup; G 16 x B 8 x T 512 synthetic windows per
group with ``<SEP>`` at every 97th position. Weights are random, from a
seed.

Run on a CUDA card, it takes warm-up groups, times measured groups without
the profiler and a few more under ``torch.profiler``, and prints JSON
lines: ms per group and non-pad tokens/s, the device time summed over
every kernel, the device's busy share, kernel launches per group, and the
kernels that take the most device time:

    python -m genomics_lm_torch.training.profile_step [--groups 3] [--top 15]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.training.optim import build_optimizer
from genomics_lm_torch.training.train_step import LossConfig, make_train_step

MAIN_TRAIN = dict(vocab_size=68, block_size=512, n_layer=10, n_head=8, n_embd=384,
                  dropout=0.1, label_smoothing=0.05, sep_id=3, tie_embeddings=True,
                  attention_impl="flash", compute_dtype="bfloat16", fused_qkv=True)
RUN_CFG = {"lr": 3e-4, "lr_embedding": 3e-4, "min_lr": 3e-5, "weight_decay": 0.05,
           "warmup_steps": 100, "scheduler": "cosine"}
TOTAL_STEPS = 5000
G, B, T = 16, 8, 512
SEED = 1337
BATCHES = 4  # distinct groups of tokens the timed runs rotate through


def make_batch(seed: int, device, groups: int = G, batch: int = B, length: int = T) -> dict:
    """One group of synthetic windows: tokens 4..67, ``<SEP>`` (3) at every
    97th position, targets shifted by one with ``<EOS_CDS>`` (2) last."""
    r = np.random.default_rng(seed)
    x = r.integers(4, 68, (groups, batch, length))
    x[..., ::97] = 3
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    return {"x": torch.from_numpy(x).to(device), "y": torch.from_numpy(y).to(device)}


def build_main(device, seed: int = SEED):
    """(cfg, model, optimizer bundle, step) of the training main path."""
    cfg = CodonGPTConfig(**MAIN_TRAIN)
    torch.manual_seed(seed)
    model = CodonGPT(cfg).to(device)
    bundle = build_optimizer(RUN_CFG, model, total_steps=TOTAL_STEPS)
    step = make_train_step(cfg, LossConfig())
    return cfg, model, bundle, step


def run_groups(model, bundle, step, batches: list, gen, n: int) -> tuple[float, list]:
    """Take ``n`` group steps, rotating through ``batches``, between two
    device synchronisations: (seconds, each group's metrics)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [step(model, bundle, batches[i % len(batches)], gen, 1.0) for i in range(n)]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, metrics


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=3, help="measured and profiled groups")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    cfg, model, bundle, step = build_main("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batches = [make_batch(s, "cuda") for s in range(BATCHES)]
    nonpad = int((batches[0]["y"] != 0).sum())

    def run(n):
        return run_groups(model, bundle, step, batches, gen, n)

    run(2)  # warm-up: cuBLAS handles, the allocator, the kernel build
    plain_s, metrics = run(args.groups)
    metrics = metrics[-1]
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        prof_s, _ = run(args.groups)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    n = args.groups
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "groups": n,
        "group_shape": [G, B, T], "nonpad_tokens_per_group": nonpad,
        "ms_per_group": plain_s * 1e3 / n,
        "nonpad_tokens_per_s": nonpad * n / plain_s,
        "profiled_ms_per_group": prof_s * 1e3 / n,
        "device_ms_per_group": device_us / 1e3 / n,
        # the profiler slows the host, not the kernels: the busy share of the
        # unprofiled groups divides the same device time by their wall time
        "device_busy_share": device_us / 1e6 / plain_s,
        "device_busy_share_profiled": device_us / 1e6 / prof_s,
        "kernel_launches_per_group": launches / n,
        "last_loss": float(metrics["total_loss_sum"]) / max(
            1, int(metrics["committed_microbatches"])),
    }))
    for e in sorted(kernels, key=_device_us, reverse=True)[: args.top]:
        print(json.dumps({"kernel": e.key[:120], "launches_per_group": e.count / n,
                          "device_ms_per_group": _device_us(e) / 1e3 / n,
                          "share_of_device": _device_us(e) / device_us}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
