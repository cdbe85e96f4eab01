"""Checkpoint model expansion (twin of ``genomics_lm_tpu/training/expansion.py``
and ``scripts/expand_model.py``).

A target model of the new shape is initialized fresh, then every source
leaf is copied into the overlapping hyperrectangle of its same-named target
leaf (extra rows and columns keep their fresh init). Stacked block leaves
also expand on the leading layer axis, so depth growth copies the first
``n_layer_src`` layers. The trees are the JAX layout of the checkpoints, so
the walk and the copy are the JAX functions over numpy; only the fresh
init differs: the port's ``CodonGPT`` under ``torch.manual_seed(seed)``
(the JAX init's distributions, another random stream).

    python -m genomics_lm_torch.training.expansion --checkpoint src.npz \\
        --out_checkpoint dst.npz --n_layer 12 --n_head 8 --n_embd 512
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.utils.weights import params_to_jax


def _copy_overlap(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    out = np.array(dst)
    if src.ndim != dst.ndim:
        return out
    slices = tuple(slice(0, min(s, d)) for s, d in zip(src.shape, dst.shape))
    out[slices] = np.asarray(src)[slices]
    return out


def _walk(src_tree, dst_tree, report, path=""):
    if isinstance(dst_tree, dict):
        out = {}
        for key, dst_val in dst_tree.items():
            if isinstance(src_tree, dict) and key in src_tree:
                out[key] = _walk(src_tree[key], dst_val, report, f"{path}/{key}")
            else:
                report["missing_initialized"].append(f"{path}/{key}")
                out[key] = dst_val
        return out
    src = np.asarray(src_tree)
    dst = np.asarray(dst_tree)
    if src.shape == dst.shape:
        report["copied"].append(path)
        return src.astype(dst.dtype)
    report["expanded"].append(path)
    return _copy_overlap(src, dst).astype(dst.dtype)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def init_tree(cfg: CodonGPTConfig, seed: int = 0) -> dict:
    """A fresh ``CodonGPT(cfg)`` in the JAX layout, from ``seed``, its keys
    sorted as ``jax.tree.map`` leaves them (the walk's report order)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return _sorted(params_to_jax(CodonGPT(cfg), cfg))


def expand_params(
    src_params: dict,
    src_cfg: CodonGPTConfig,
    dst_cfg: CodonGPTConfig,
    *,
    seed: int = 0,
) -> tuple[dict, dict]:
    """Expand ``src_params`` into a fresh ``dst_cfg`` init. Returns
    (params, report{copied, expanded, missing_initialized})."""
    report = {"copied": [], "expanded": [], "missing_initialized": []}
    out = _walk(src_params, init_tree(dst_cfg, seed), report)
    return out, report


def expand_checkpoint(
    src_payload: dict, dst_cfg: CodonGPTConfig, *, seed: int = 0
) -> tuple[dict, dict]:
    """Expand a full checkpoint payload into a fresh training start."""
    src_cfg = CodonGPTConfig.from_run_config(src_payload.get("cfg", {}))
    params, report = expand_params(src_payload["model"], src_cfg, dst_cfg, seed=seed)
    cfg_out = dict(src_payload.get("cfg", {}))
    cfg_out.update({
        "n_layer": dst_cfg.n_layer,
        "n_head": dst_cfg.n_head,
        "n_embd": dst_cfg.n_embd,
        "block_size": dst_cfg.block_size,
        "vocab_size": dst_cfg.vocab_size,
    })
    payload = {
        "model": params,
        "cfg": cfg_out,
        "epoch": 0,
        "step": 0,
        "best_val": float("inf"),
        "no_improve": 0,
        "run_progress": {
            "completed_epochs": 0, "current_epoch": 0,
            "microbatch": 0, "optimizer_step": 0,
        },
        "expansion_report": {k: len(v) for k, v in report.items()},
    }
    return payload, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Expand a checkpoint to a wider/deeper model")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out_checkpoint", required=True)
    ap.add_argument("--n_layer", type=int, required=True)
    ap.add_argument("--n_head", type=int, required=True)
    ap.add_argument("--n_embd", type=int, required=True)
    ap.add_argument("--block_size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from genomics_lm_torch.training.checkpoints import load_checkpoint, save_checkpoint

    payload = load_checkpoint(args.checkpoint)
    src_cfg = dict(payload.get("cfg", {}))
    dst_map = dict(src_cfg)
    dst_map.update(
        n_layer=args.n_layer, n_head=args.n_head, n_embd=args.n_embd,
        block_size=args.block_size or src_cfg.get("block_size", 512),
    )
    dst_cfg = CodonGPTConfig.from_run_config(dst_map)
    out_payload, report = expand_checkpoint(payload, dst_cfg, seed=args.seed)
    out_path = Path(args.out_checkpoint)
    save_checkpoint(out_payload, out_path)
    print(
        f"[expand] copied={len(report['copied'])} expanded={len(report['expanded'])} "
        f"missing_initialized={len(report['missing_initialized'])} → {out_path}"
    )
    return 0


__all__ = ["expand_checkpoint", "expand_params", "init_tree", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
