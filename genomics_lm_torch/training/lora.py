"""LoRA adapters on JAX-layout trees (twin of ``genomics_lm_tpu/training/lora.py``).

The functions work on the parameter tree as the checkpoints hold it
(nested dicts of numpy arrays, per-layer leaves stacked on a leading L
axis) and compute what the JAX functions compute:

- ``add_lora_adapters``: on each target block linear, ``lora_a`` (L,
  fan_in, r) drawn U(±1/√fan_in) from a numpy generator (JAX draws from
  its key, so the values differ; the distribution is the same),
  ``lora_b`` (L, r, fan_out) = 0, so the adapted model equals the base
  until the first step, and the frozen ``lora_scale`` (L,) = alpha / r.
  Targets: ``attn`` (query, key, value, proj) or ``attn+mlp``; int8
  targets and MLP targets on an MoE model are refused;
- ``merge_lora`` folds ``scale * a @ b`` into ``w`` and drops the adapter
  leaves; ``adapter_state`` / ``apply_adapter_state`` take the adapters
  out of a tree and graft them onto another; ``has_lora`` and
  ``lora_param_count`` (the frozen scale excluded).

The model holds the adapters as ``models/codon_gpt.py::LoRA`` modules
(``utils/weights.py`` maps the leaves); the trainer attaches them with
``add_lora_adapters`` on the tree of the transferred base.
"""

from __future__ import annotations

import math

import numpy as np

from genomics_lm_torch.models.codon_gpt import ATTN_LINEARS, MLP_LINEARS

__all__ = [
    "add_lora_adapters",
    "adapter_state",
    "apply_adapter_state",
    "has_lora",
    "lora_param_count",
    "merge_lora",
]


def _copy_containers(node):
    if isinstance(node, dict):
        return {k: _copy_containers(v) for k, v in node.items()}
    return node


def _attach(linear: dict, rng: np.random.Generator, rank: int, scale: float) -> None:
    w = np.asarray(linear["w"])
    if w.ndim != 3:
        raise ValueError(
            f"LoRA targets expect stacked block linears (L, fan_in, fan_out); "
            f"got shape {w.shape}"
        )
    n_layer, fan_in, fan_out = w.shape
    k = 1.0 / math.sqrt(fan_in)
    linear["lora_a"] = rng.uniform(-k, k, (n_layer, fan_in, rank)).astype(np.float32)
    linear["lora_b"] = np.zeros((n_layer, rank, fan_out), np.float32)
    linear["lora_scale"] = np.full((n_layer,), scale, np.float32)


def add_lora_adapters(
    params: dict,
    rng: np.random.Generator,
    *,
    rank: int,
    alpha: float | None = None,
    targets: str = "attn",
) -> dict:
    """Return a copy of ``params`` with adapters on the target block linears.

    ``targets``: ``"attn"`` (q/k/v/out-proj) or ``"attn+mlp"`` (also the
    dense/SwiGLU MLP linears). Call after any ``transfer_load_params`` so
    the base tree matches the source checkpoint.
    """
    if rank < 1:
        raise ValueError("lora rank must be >= 1")
    if targets not in ("attn", "attn+mlp"):
        raise ValueError(f"unknown lora targets {targets!r}")
    params = _copy_containers(params)
    blocks = params["blocks"]
    scale = (alpha if alpha is not None else float(rank)) / float(rank)

    chosen: list[dict] = [blocks["attn"][name] for name in ATTN_LINEARS]
    if targets == "attn+mlp":
        if "router" in blocks:
            raise ValueError(
                "LoRA mlp targets are unsupported on MoE models — expert "
                "banks are excluded from adaptation (use targets='attn')"
            )
        chosen += [
            blocks["mlp"][name] for name in MLP_LINEARS if name in blocks["mlp"]
        ]
    for linear in chosen:
        if "w_q" in linear:
            raise ValueError(
                "cannot attach LoRA to int8-quantized weights — fine-tune "
                "the float checkpoint, merge, then quantize"
            )
        _attach(linear, rng, rank, scale)
    return params


def _merge_node(node):
    if isinstance(node, dict) and "lora_a" in node:
        node = dict(node)
        a, b = np.asarray(node.pop("lora_a")), np.asarray(node.pop("lora_b"))
        delta = np.einsum("...ir,...ro->...io", a, b)
        if "lora_scale" in node:
            scale = np.asarray(node.pop("lora_scale"))  # (L,) over (L, in, out)
            delta = delta * scale[..., None, None]
        w = np.asarray(node["w"])
        node["w"] = w + delta.astype(w.dtype)
        return node
    if isinstance(node, dict):
        return {k: _merge_node(v) for k, v in node.items()}
    return node


def merge_lora(params: dict) -> dict:
    """Fold every adapter into its base weight; drop the adapter leaves.
    The result is a plain dense tree."""
    return _merge_node(params)


def adapter_state(params: dict) -> dict:
    """Only the adapter leaves, tree structure preserved."""
    def visit(node):
        if not isinstance(node, dict):
            return None
        if "lora_a" in node:
            return {k: v for k, v in node.items() if k.startswith("lora_")}
        out = {k: r for k, r in ((k, visit(v)) for k, v in node.items())
               if r is not None}
        return out or None

    found = visit(params)
    if found is None:
        raise ValueError("params carry no LoRA adapter leaves")
    return found


def apply_adapter_state(params: dict, adapters: dict) -> dict:
    """Graft an ``adapter_state`` tree onto a base parameter tree (the base
    the adapters were trained against); shapes are validated."""
    params = _copy_containers(params)

    def graft(dst, src, path=""):
        for k, v in src.items():
            if k.startswith("lora_"):
                if "w" not in dst:
                    raise ValueError(f"no linear at {path!r} to adapt")
                w_shape = np.shape(dst["w"])
                expect = (w_shape[:-1] if k == "lora_a"
                          else w_shape[:-2] if k == "lora_scale"
                          else None)
                if expect is not None and tuple(np.shape(v)[: len(expect)]) != tuple(expect):
                    raise ValueError(
                        f"adapter leaf {path}/{k} shape {np.shape(v)} does not "
                        f"match base linear {w_shape}")
                dst[k] = v
            else:
                if k not in dst:
                    raise ValueError(f"base tree has no node {path}/{k}")
                graft(dst[k], v, f"{path}/{k}")

    graft(params, adapters)
    return params


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, node


def has_lora(params: dict) -> bool:
    return any("lora_a" in path for path, _ in _leaves(params))


def lora_param_count(params: dict) -> int:
    """Trainable adapter parameters (the frozen ``lora_scale`` leaf excluded)."""
    return int(sum(np.size(leaf) for path, leaf in _leaves(params)
                   if "lora_" in path and "lora_scale" not in path))
