"""Load a JAX CodonGPT parameter tree into the port's ``CodonGPT`` module.

The tree is given as nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, params)`` — this module never imports JAX.

Layout map (JAX param tree → ``CodonGPT.state_dict`` key; the keys follow
the reference ``TinyGPT`` layout):

====================================  =================================  =========
JAX leaf                              state_dict key                     transform
====================================  =================================  =========
``tok_emb``                (V, D)     ``tok_emb.weight``        (V, D)   none
``pos_emb``                (P, D)     ``pos_emb.weight``        (P, D)   none
``blocks/ln1/scale``    [L] (D,)      ``blocks.{i}.ln1.weight``          unstack
``blocks/ln1/bias``     [L] (D,)      ``blocks.{i}.ln1.bias``            unstack
``blocks/attn/query/w`` [L] (D, D)    ``blocks.{i}.attn.query.weight``   unstack + T
``blocks/attn/key/w``   [L] (D, Dkv)  ``blocks.{i}.attn.key.weight``     unstack + T
``blocks/attn/value/w`` [L] (D, Dkv)  ``blocks.{i}.attn.value.weight``   unstack + T
``blocks/attn/proj/w``  [L] (D, D)    ``blocks.{i}.attn.proj.weight``    unstack + T
``blocks/attn/*/b``     [L] (out,)    ``blocks.{i}.attn.*.bias``         unstack
``blocks/ln2/*``                      ``blocks.{i}.ln2.*``               unstack
``blocks/mlp/fc/{w,b}``               ``blocks.{i}.mlp.0.{weight,bias}`` unstack + T
``blocks/mlp/proj/{w,b}``             ``blocks.{i}.mlp.2.{weight,bias}`` unstack + T
``blocks/mlp/w_gate/w``               ``blocks.{i}.mlp.w_gate.weight``   unstack + T
``blocks/mlp/w_up/w``                 ``blocks.{i}.mlp.w_up.weight``     unstack + T
``blocks/mlp/w_down/w``               ``blocks.{i}.mlp.w_down.weight``   unstack + T
``ln_f/{scale,bias}``                 ``ln_f.{weight,bias}``             none
``head/w``                 (D, V)     ``head.weight``           (V, D)   T (untied)
``termination_head/{w,b}``            ``termination_head.{weight,bias}`` T
``shape_proj/{w,b}``       (3, D)     ``shape_proj.{weight,bias}``       T
``offset_projs/{o}/fc/{w,b}``         ``offset_projs.{o}.0.{weight,bias}``  T
``offset_projs/{o}/proj/{w,b}``       ``offset_projs.{o}.2.{weight,bias}``  T
====================================  =================================  =========

JAX stores a linear weight as (in, out), torch as (out, in), so every
linear weight transposes ("T"); per-layer leaves are stacked on a leading
L axis in JAX. One key departs from the reference layout: a model built
with ``fused_qkv`` holds ``blocks.{i}.attn.qkv.{weight,bias}``, the query,
key and value linears concatenated along the output at load time.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.float32)))


def _check_dense(tree: dict, where: str) -> None:
    if "w_q" in tree:
        raise NotImplementedError(f"weight-only int8 linears ({where}) are not ported")
    if "lora_a" in tree:
        raise NotImplementedError(f"LoRA linears ({where}) are not ported")


def _linear(tree: dict, where: str, i: int | None = None) -> dict[str, torch.Tensor]:
    _check_dense(tree, where)
    pick = (lambda a: a[i]) if i is not None else (lambda a: a)
    out = {"weight": _f32(pick(tree["w"])).t().contiguous()}
    if "b" in tree:
        out["bias"] = _f32(pick(tree["b"]))
    return out


def _put(sd: dict, prefix: str, tensors: dict[str, torch.Tensor]) -> None:
    for name, t in tensors.items():
        sd[f"{prefix}.{name}"] = t


def state_dict_from_jax(tree: dict, cfg: CodonGPTConfig) -> dict[str, torch.Tensor]:
    """The ``CodonGPT(cfg).state_dict()`` that carries the JAX tree's weights."""
    if cfg.moe_experts or "router" in tree.get("blocks", {}):
        raise NotImplementedError("MoE MLP (moe_experts > 0) is not ported")
    sd: dict[str, torch.Tensor] = {"tok_emb.weight": _f32(tree["tok_emb"])}
    if not cfg.use_rope:
        sd["pos_emb.weight"] = _f32(tree["pos_emb"])
    blocks = tree["blocks"]
    attn = blocks["attn"]
    for i in range(cfg.n_layer):
        p = f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{p}.{ln}.weight"] = _f32(blocks[ln]["scale"][i])
            sd[f"{p}.{ln}.bias"] = _f32(blocks[ln]["bias"][i])
        parts = [_linear(attn[n], f"attn/{n}", i) for n in ("query", "key", "value")]
        if cfg.fused_qkv:
            _put(sd, f"{p}.attn.qkv", {
                "weight": torch.cat([t["weight"] for t in parts], dim=0),
                "bias": torch.cat([t["bias"] for t in parts], dim=0),
            })
        else:
            for name, t in zip(("query", "key", "value"), parts):
                _put(sd, f"{p}.attn.{name}", t)
        _put(sd, f"{p}.attn.proj", _linear(attn["proj"], "attn/proj", i))
        mlp = blocks["mlp"]
        if cfg.use_swiglu:
            for name in ("w_gate", "w_up", "w_down"):
                _put(sd, f"{p}.mlp.{name}", _linear(mlp[name], f"mlp/{name}", i))
        else:
            _put(sd, f"{p}.mlp.0", _linear(mlp["fc"], "mlp/fc", i))
            _put(sd, f"{p}.mlp.2", _linear(mlp["proj"], "mlp/proj", i))
    sd["ln_f.weight"] = _f32(tree["ln_f"]["scale"])
    sd["ln_f.bias"] = _f32(tree["ln_f"]["bias"])
    if not cfg.tie_embeddings:
        _put(sd, "head", _linear(tree["head"], "head"))
    if cfg.termination_aux:
        _put(sd, "termination_head", _linear(tree["termination_head"], "termination_head"))
    if cfg.use_shape_guidance:
        _put(sd, "shape_proj", _linear(tree["shape_proj"], "shape_proj"))
    for o in cfg.multi_offset_targets:
        proj = tree["offset_projs"][str(o)]
        _put(sd, f"offset_projs.{o}.0", _linear(proj["fc"], f"offset_projs/{o}/fc"))
        _put(sd, f"offset_projs.{o}.2", _linear(proj["proj"], f"offset_projs/{o}/proj"))
    return sd


def params_from_jax(tree: dict, cfg: CodonGPTConfig,
                    device: str | torch.device) -> CodonGPT:
    """A ``CodonGPT`` on ``device`` holding the JAX tree's weights (float32).

    Every key must match: a leaf missing from the tree, or one the port
    has no place for, raises.
    """
    model = CodonGPT(cfg)
    model.load_state_dict(state_dict_from_jax(tree, cfg), strict=True)
    return model.to(device).eval()


__all__ = ["params_from_jax", "state_dict_from_jax"]
