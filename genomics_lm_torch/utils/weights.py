"""Move CodonGPT weights between the JAX parameter tree and the port's module.

The tree is given as nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, params)`` — this module never imports JAX.
``params_from_jax`` loads a tree into a ``CodonGPT``; ``params_to_jax`` is
its inverse, the layout the checkpoints store, so the JAX package loads a
model trained by the port and the port loads one trained by JAX. A round
trip tree → module → tree is exact: the maps only transpose, stack and
split float32 arrays.

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


class _TreeReader:
    """Reads leaves of a nested-dict tree by path and remembers which it read."""

    def __init__(self, tree: dict):
        self.tree = tree
        self.used: set[tuple[str, ...]] = set()

    def node(self, *path: str):
        node = self.tree
        for key in path:
            node = node[key]
        return node

    def leaf(self, *path: str):
        self.used.add(path)
        return self.node(*path)

    def unused(self) -> list[str]:
        """The paths ("a/b/c") of the tree's leaves that were never read."""
        def walk(node, prefix):
            for key, child in node.items():
                if isinstance(child, dict):
                    yield from walk(child, prefix + (key,))
                elif prefix + (key,) not in self.used:
                    yield "/".join(prefix + (key,))
        return sorted(walk(self.tree, ()))


def _check_dense(tree: dict, where: str) -> None:
    if "w_q" in tree:
        raise NotImplementedError(f"weight-only int8 linears ({where}) are not ported")
    if "lora_a" in tree:
        raise NotImplementedError(f"LoRA linears ({where}) are not ported")


def _linear(tree: _TreeReader, path: tuple[str, ...], i: int | None = None
            ) -> dict[str, torch.Tensor]:
    node = tree.node(*path)
    _check_dense(node, "/".join(path))
    pick = (lambda a: a[i]) if i is not None else (lambda a: a)
    out = {"weight": _f32(pick(tree.leaf(*path, "w"))).t().contiguous()}
    if "b" in node:
        out["bias"] = _f32(pick(tree.leaf(*path, "b")))
    return out


def _put(sd: dict, prefix: str, tensors: dict[str, torch.Tensor]) -> None:
    for name, t in tensors.items():
        sd[f"{prefix}.{name}"] = t


def state_dict_from_jax(tree: dict, cfg: CodonGPTConfig) -> dict[str, torch.Tensor]:
    """The ``CodonGPT(cfg).state_dict()`` that carries the JAX tree's weights.

    Raises ``ValueError`` naming every leaf of the tree that ``cfg`` leaves
    unread (a head or a projection the config does not have, a stray leaf):
    nothing is dropped without a word.
    """
    if cfg.moe_experts or "router" in tree.get("blocks", {}):
        raise NotImplementedError("MoE MLP (moe_experts > 0) is not ported")
    t = _TreeReader(tree)
    sd: dict[str, torch.Tensor] = {"tok_emb.weight": _f32(t.leaf("tok_emb"))}
    if not cfg.use_rope:
        sd["pos_emb.weight"] = _f32(t.leaf("pos_emb"))
    for i in range(cfg.n_layer):
        p = f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{p}.{ln}.weight"] = _f32(t.leaf("blocks", ln, "scale")[i])
            sd[f"{p}.{ln}.bias"] = _f32(t.leaf("blocks", ln, "bias")[i])
        parts = [_linear(t, ("blocks", "attn", n), i) for n in ("query", "key", "value")]
        if cfg.fused_qkv:
            _put(sd, f"{p}.attn.qkv", {
                "weight": torch.cat([x["weight"] for x in parts], dim=0),
                "bias": torch.cat([x["bias"] for x in parts], dim=0),
            })
        else:
            for name, x in zip(("query", "key", "value"), parts):
                _put(sd, f"{p}.attn.{name}", x)
        _put(sd, f"{p}.attn.proj", _linear(t, ("blocks", "attn", "proj"), i))
        if cfg.use_swiglu:
            for name in ("w_gate", "w_up", "w_down"):
                _put(sd, f"{p}.mlp.{name}", _linear(t, ("blocks", "mlp", name), i))
        else:
            _put(sd, f"{p}.mlp.0", _linear(t, ("blocks", "mlp", "fc"), i))
            _put(sd, f"{p}.mlp.2", _linear(t, ("blocks", "mlp", "proj"), i))
    sd["ln_f.weight"] = _f32(t.leaf("ln_f", "scale"))
    sd["ln_f.bias"] = _f32(t.leaf("ln_f", "bias"))
    if not cfg.tie_embeddings:
        _put(sd, "head", _linear(t, ("head",)))
    if cfg.termination_aux:
        _put(sd, "termination_head", _linear(t, ("termination_head",)))
    if cfg.use_shape_guidance:
        _put(sd, "shape_proj", _linear(t, ("shape_proj",)))
    for o in cfg.multi_offset_targets:
        _put(sd, f"offset_projs.{o}.0", _linear(t, ("offset_projs", str(o), "fc")))
        _put(sd, f"offset_projs.{o}.2", _linear(t, ("offset_projs", str(o), "proj")))
    unused = t.unused()
    if unused:
        raise ValueError(f"the tree has leaves this config has no place for: {unused}")
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


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def params_to_jax(model: CodonGPT, cfg: CodonGPTConfig) -> dict:
    """The JAX parameter tree (nested dicts of float32 numpy arrays) that
    carries ``model``'s weights: the inverse of ``params_from_jax``.

    Per-layer leaves stack on a leading L axis, linear weights transpose to
    (in, out), and a fused QKV linear splits back into query, key and
    value.
    """
    sd = {k: v.detach() for k, v in model.state_dict().items()}

    def lin(prefix: str) -> dict[str, np.ndarray]:
        out = {"w": _np(sd[f"{prefix}.weight"]).T.copy()}
        if f"{prefix}.bias" in sd:
            out["b"] = _np(sd[f"{prefix}.bias"])
        return out

    def stacked(fn) -> dict:
        per_layer = [fn(i) for i in range(cfg.n_layer)]

        def merge(nodes):
            if isinstance(nodes[0], dict):
                return {k: merge([n[k] for n in nodes]) for k in nodes[0]}
            return np.stack(nodes)

        return merge(per_layer)

    def block(i: int) -> dict:
        p = f"blocks.{i}"
        out = {ln: {"scale": _np(sd[f"{p}.{ln}.weight"]), "bias": _np(sd[f"{p}.{ln}.bias"])}
               for ln in ("ln1", "ln2")}
        if cfg.fused_qkv:
            w = _np(sd[f"{p}.attn.qkv.weight"])
            b = _np(sd[f"{p}.attn.qkv.bias"])
            c_q, c_kv = cfg.n_head * cfg.head_dim, cfg.kv_heads * cfg.head_dim
            cuts = np.cumsum([c_q, c_kv])
            attn = {name: {"w": ww.T.copy(), "b": bb.copy()} for name, ww, bb in
                    zip(("query", "key", "value"), np.split(w, cuts), np.split(b, cuts))}
        else:
            attn = {name: lin(f"{p}.attn.{name}") for name in ("query", "key", "value")}
        attn["proj"] = lin(f"{p}.attn.proj")
        out["attn"] = attn
        if cfg.use_swiglu:
            out["mlp"] = {name: lin(f"{p}.mlp.{name}") for name in ("w_gate", "w_up", "w_down")}
        else:
            out["mlp"] = {"fc": lin(f"{p}.mlp.0"), "proj": lin(f"{p}.mlp.2")}
        return out

    tree: dict = {"tok_emb": _np(sd["tok_emb.weight"]),
                  "ln_f": {"scale": _np(sd["ln_f.weight"]), "bias": _np(sd["ln_f.bias"])}}
    if not cfg.use_rope:
        tree["pos_emb"] = _np(sd["pos_emb.weight"])
    tree["blocks"] = stacked(block)
    if not cfg.tie_embeddings:
        tree["head"] = lin("head")
    if cfg.termination_aux:
        tree["termination_head"] = lin("termination_head")
    if cfg.use_shape_guidance:
        tree["shape_proj"] = lin("shape_proj")
    if cfg.multi_offset_targets:
        tree["offset_projs"] = {
            str(o): {"fc": lin(f"offset_projs.{o}.0"), "proj": lin(f"offset_projs.{o}.2")}
            for o in cfg.multi_offset_targets}
    return tree


__all__ = ["params_from_jax", "params_to_jax", "state_dict_from_jax"]
