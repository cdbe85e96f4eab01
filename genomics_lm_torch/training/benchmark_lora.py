"""LoRA efficiency at the flagship tier (twin of
``scripts/benchmark_lora.py::run_d512_efficiency``).

At 12L8H d512 (block 512, fused QKV, bf16, flash attention, dropout 0.1,
label smoothing 0.05), from random weights made from a seed:

- **checkpoint bytes**: the dense model checkpoint against the
  adapter-only state (``training/lora.py::adapter_state``), both as files;
  the adapters, re-attached to the reloaded dense tree with
  ``apply_adapter_state``, must forward exactly as the adapted model;
- **optimizer-state bytes**: AdamW moments for full fine-tuning against
  ``lora_only`` (frozen parameters are in no group and hold no state);
- **ms per group step** of one microbatch of B x 512 tokens, full
  fine-tuning against LoRA rank r on the attention linears (the frozen
  weights take no gradient: ``requires_grad=False``), with the flash
  kernels' launches per step.

    python -m genomics_lm_torch.training.benchmark_lora [--d512_batch 8] [--d512_steps 10]

It runs on the CUDA card (``--device cpu`` only for a small ``model``
from Python) and prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops import flash_attention as fa
from genomics_lm_torch.training import checkpoints as ckpt_lib
from genomics_lm_torch.training import lora as lora_lib
from genomics_lm_torch.training.optim import build_optimizer
from genomics_lm_torch.training.train_step import LossConfig, make_train_step
from genomics_lm_torch.utils.device import resolve_device
from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax

D512_MODEL = {
    "vocab_size": 68, "block_size": 512, "n_layer": 12, "n_head": 8,
    "n_embd": 512, "dropout": 0.1, "label_smoothing": 0.05, "sep_id": 3,
    "tie_embeddings": True, "attention_impl": "flash",
    "compute_dtype": "bfloat16", "fused_qkv": True,
    "flash_block_q": 512, "flash_block_k": 512,
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_d512_efficiency(args, device=None, model: dict = D512_MODEL) -> dict:
    """Bytes and step time of full fine-tuning against LoRA (see the module
    docstring); ``args`` carries ``workdir``, ``d512_rank``, ``d512_batch``,
    ``d512_warmup`` and ``d512_steps``."""
    device = resolve_device(device)
    cfg = CodonGPTConfig.from_run_config(dict(model))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        base = params_to_jax(CodonGPT(cfg), cfg)
    adapted = lora_lib.add_lora_adapters(base, np.random.default_rng(1), rank=args.d512_rank)

    workdir = Path(args.workdir) / "d512_efficiency"
    workdir.mkdir(parents=True, exist_ok=True)
    dense_path = workdir / "dense_model.npz"
    adapters_path = workdir / "adapters_only.npz"
    ckpt_lib.save_checkpoint({"model": base}, dense_path)
    ckpt_lib.save_checkpoint({"adapters": lora_lib.adapter_state(adapted)}, adapters_path)
    dense_bytes = dense_path.stat().st_size
    adapter_bytes = adapters_path.stat().st_size

    # round trip: the re-attached adapters forward exactly as the originals
    # (plain attention on a short probe, as the JAX script does)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(4, 68, (2, 64))).to(device)
    probe_cfg = cfg.replace(attention_impl="xla", dropout=0.0)
    reattached = lora_lib.apply_adapter_state(
        ckpt_lib.load_checkpoint(dense_path)["model"],
        ckpt_lib.load_checkpoint(adapters_path)["adapters"])
    with torch.no_grad():
        got, _ = codon_gpt.forward(params_from_jax(reattached, probe_cfg, device), probe_cfg, x)
        want, _ = codon_gpt.forward(params_from_jax(adapted, probe_cfg, device), probe_cfg, x)
    roundtrip_err = float((got.float() - want.float()).abs().max())
    if roundtrip_err != 0.0:
        raise AssertionError(f"re-attached adapters forward differently ({roundtrip_err})")

    def measure(tag, tree, run_cfg):
        net = params_from_jax(tree, cfg, device).train()
        bundle = build_optimizer(run_cfg, net, total_steps=100)
        step = make_train_step(cfg, LossConfig(label_smoothing=0.05))
        shape = (1, args.d512_batch, cfg.block_size)
        batch = {"x": torch.from_numpy(rng.integers(4, 68, shape)).to(device),
                 "y": torch.from_numpy(rng.integers(4, 68, shape)).to(device)}
        gen = torch.Generator(device=device).manual_seed(2)
        for _ in range(args.d512_warmup):
            m = step(net, bundle, batch, gen, 1.0)
        _sync(device)
        before = fa.flash_fwd.launches
        t0 = time.perf_counter()
        for _ in range(args.d512_steps):
            m = step(net, bundle, batch, gen, 1.0)
        _sync(device)
        dt = (time.perf_counter() - t0) / args.d512_steps
        if not bool(m["applied"]):
            raise AssertionError(f"{tag}: the last step was not applied")
        trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
        row = {
            "mode": tag,
            "trainable_params": int(trainable),
            "opt_state_bytes": bundle.state_bytes(),
            "step_wall_sec": dt,
            "ms_per_step": dt * 1e3,
            "tokens_per_sec": args.d512_batch * cfg.block_size / dt,
            "flash_fwd_launches_per_step": (fa.flash_fwd.launches - before) / args.d512_steps,
            "loss": float(m["total_loss_sum"]),
        }
        print(f"[lora-d512] {tag}: {trainable:,} trainable, "
              f"moments {row['opt_state_bytes'] / 2**20:.1f} MiB, "
              f"{dt * 1e3:.1f} ms/step", flush=True)
        return row

    full = measure("full_finetune", base, {"lr": 3e-4, "warmup_steps": 0})
    lora = measure(f"lora_r{args.d512_rank}", adapted,
                   {"lr": 3e-4, "warmup_steps": 0, "lora_rank": args.d512_rank})
    return {
        "protocol": (
            f"{cfg.n_layer}L{cfg.n_head}H d{cfg.n_embd} block{cfg.block_size} "
            f"b{args.d512_batch}, {args.d512_warmup} warmup + {args.d512_steps} timed "
            f"steps; LoRA rank {args.d512_rank} attn targets, lora_only"),
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "checkpoint_bytes": {
            "dense_model": dense_bytes,
            "adapter_only": adapter_bytes,
            "ratio": adapter_bytes / dense_bytes,
        },
        "adapter_params": lora_lib.lora_param_count(adapted),
        "roundtrip_max_abs_err": roundtrip_err,
        "full_finetune": full,
        "lora": lora,
        "opt_state_ratio": lora["opt_state_bytes"] / full["opt_state_bytes"],
        "step_time_ratio": lora["step_wall_sec"] / full["step_wall_sec"],
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LoRA efficiency at 12L8H d512 on the card")
    ap.add_argument("--workdir", default="outputs/lora_transfer")
    ap.add_argument("--d512_rank", type=int, default=8)
    ap.add_argument("--d512_batch", type=int, default=8)
    ap.add_argument("--d512_warmup", type=int, default=3)
    ap.add_argument("--d512_steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    print(json.dumps(run_d512_efficiency(args, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
