"""Profile a short training run under ``torch.profiler`` (twin of
``scripts/profile_train.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.training.profile_train [--out_dir outputs/profiles] \\
        [--n_layer 10] [--n_head 8] [--n_embd 384] [--block_size 512] \\
        [--batch_size 32] [--grad_accum 4] [--steps 5] [--device cpu]

The model is the script's: 10L8H d384, block 512, dropout 0.1, random
weights from a seed; on the card flash attention in bfloat16, on the CPU
(``--device cpu``) the plain path in float32, as JAX picks by backend. The
step is the port's group step (``LossConfig()``, AdamW at lr 3e-4 after 10
warm-up steps of 1000) over one G x B x T batch of random codons drawn
from ``np.random.default_rng(0)``, targets shifted by one with
``<EOS_CDS>`` (2) last. One step runs outside the trace (the kernels'
build, cuBLAS handles, the allocator); the ``--steps`` traced steps run
under ``torch.profiler`` with a TensorBoard trace handler writing into
``--out_dir`` (the counterpart of ``jax.profiler.trace``), each timed
between two ``utils/sync.py::hard_sync`` calls on its metrics.
``summary.txt`` in ``--out_dir`` holds the script's seven lines.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def make_batch(grad_accum: int, batch_size: int, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The script's (G, B, T) int32 tokens and targets from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    x = rng.integers(4, 68, (grad_accum, batch_size, block_size)).astype(np.int32)
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    return x, y


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default="outputs/profiles")
    ap.add_argument("--n_layer", type=int, default=10)
    ap.add_argument("--n_head", type=int, default=8)
    ap.add_argument("--n_embd", type=int, default=384)
    ap.add_argument("--block_size", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--grad_accum", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import torch

    from genomics_lm_torch.models.codon_gpt import CodonGPT
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.training.optim import build_optimizer
    from genomics_lm_torch.training.train_step import LossConfig, make_train_step
    from genomics_lm_torch.utils.device import resolve_device
    from genomics_lm_torch.utils.sync import hard_sync

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = CodonGPTConfig(
        vocab_size=68, block_size=args.block_size, n_layer=args.n_layer,
        n_head=args.n_head, n_embd=args.n_embd, dropout=0.1,
        attention_impl="flash" if on_card else "xla",
        compute_dtype="bfloat16" if on_card else "float32",
    )
    torch.manual_seed(0)
    model = CodonGPT(cfg).to(device)
    bundle = build_optimizer({"lr": 3e-4, "warmup_steps": 10}, model, 1000)
    step = make_train_step(cfg, LossConfig())
    x, y = make_batch(args.grad_accum, args.batch_size, args.block_size)
    batch = {"x": torch.from_numpy(x).long().to(device),
             "y": torch.from_numpy(y).long().to(device)}
    gen = torch.Generator(device=device).manual_seed(0)

    # the kernels' build and the first launches, outside the trace
    hard_sync(step(model, bundle, batch, gen, 1.0))

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    timings = []
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(out_dir))):
        for _ in range(args.steps):
            t0 = time.perf_counter()
            hard_sync(step(model, bundle, batch, gen, 1.0))
            timings.append(time.perf_counter() - t0)

    nonpad = int((y != 0).sum())
    lines = [
        f"model: {args.n_layer}L{args.n_head}H d{args.n_embd} block{args.block_size}",
        f"batch: {args.batch_size} x gacc {args.grad_accum}",
        f"steps: {args.steps}",
        f"mean step: {sum(timings) / len(timings):.4f}s",
        f"min step: {min(timings):.4f}s",
        f"nonpad tokens/sec: {nonpad / (sum(timings) / len(timings)):.1f}",
        f"trace dir: {out_dir} (TensorBoard-compatible)",
    ]
    (out_dir / "summary.txt").write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
