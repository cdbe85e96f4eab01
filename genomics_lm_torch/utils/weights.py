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
``blocks/*/*/lora_a``  [L] (in, r)    ``blocks.{i}.*.*.lora.lora_a``     unstack
``blocks/*/*/lora_b``  [L] (r, out)   ``blocks.{i}.*.*.lora.lora_b``     unstack
``blocks/*/*/lora_scale`` [L]         ``blocks.{i}.*.*.lora.lora_scale`` unstack
``shape_encoder/conv1/{w,b}``         ``shape_encoder.conv1.{weight,bias}``  none
``shape_encoder/conv2/{w,b}``         ``shape_encoder.conv2.{weight,bias}``  none
``blocks/*/*/w_q``  [L] (in, out) int8  ``blocks.{i}.*.*.w_q``  (out, in)  unstack + T
``blocks/*/*/scale``   [L] (out,)     ``blocks.{i}.*.*.scale``           unstack
``blocks/mlp/*/w``  [L] (E, in, out)  ``blocks.{i}.mlp.*.w``  (E, in, out)  unstack (MoE)
``blocks/mlp/*/b``  [L] (E, out)      ``blocks.{i}.mlp.*.b``             unstack (MoE)
``blocks/router/w``    [L] (D, E)     ``blocks.{i}.router.w``            unstack (MoE)
====================================  =================================  =========

JAX stores a linear weight as (in, out), torch as (out, in), so every
linear weight transposes ("T"); per-layer leaves are stacked on a leading
L axis in JAX. One key departs from the reference layout: a model built
with ``fused_qkv`` holds ``blocks.{i}.attn.qkv.{weight,bias}``, the query,
key and value linears concatenated along the output at load time; their
adapters, when the tree has them, are ``blocks.{i}.attn.qkv_lora.{query,
key,value}.lora_*``. The LoRA leaves keep the JAX orientation (``*`` is
``attn/{query,key,value,proj}`` or ``mlp/{fc,proj,w_gate,w_up,w_down}``,
the port's ``attn.*`` or ``mlp.{0,2,w_*}``), and a tree without
``lora_scale`` (an older JAX checkpoint) loads with scale 1. The adapters
and the shape encoder (``models/biophysics.py``) exist in a model when
its tree has their leaves (``params_from_jax``) or when the trainer
attaches them.

A weight-only int8 tree (``genomics_lm_tpu.ops.quant.quantize_params``)
holds ``w_q`` (int8) and ``scale`` (float32) with ``b`` in place of ``w``
on each block linear; the port's linear is then an ``Int8Linear``
(``models/codon_gpt.py``), its ``w_q`` transposed and kept int8, and a fused QKV
takes the three projections' int8 rows and scales, concatenated. Both
directions keep int8 leaves int8 and every other leaf float32, so the
round trip stays exact.

A MoE tree (``moe_experts`` > 0) holds each expert linear's weights
stacked on an E axis after the L axis, ``fc``/``proj`` or ``w_gate``/
``w_up``/``w_down``, and a bias-free ``router``; the port keeps them in
that layout (``models/codon_gpt.py::MoEMLP``), so they only unstack over
L. A weight-only int8 MoE tree quantizes the attention linears only.

``jax_leaves`` is the map itself: for each JAX leaf, the port parameters
(and the rows of each) that hold it. ``params_to_jax`` and
``state_dict_from_jax`` read and write through it, and the Adafactor
optimizer (``training/optim.py``) computes its statistics on the leaves it
gives, as optax does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from genomics_lm_torch.models.biophysics import ShapeEncoder
from genomics_lm_torch.models.codon_gpt import (
    ATTN_LINEARS,
    MLP_LINEARS,
    CodonGPT,
    Int8Linear,
    attach_lora,
    block_linears,
    set_block_linear,
)
from genomics_lm_torch.models.config import CodonGPTConfig

LORA_LEAVES = ("lora_a", "lora_b", "lora_scale")


@dataclass
class JaxLeaf:
    """One leaf of the JAX tree: its path ("blocks/attn/query/w") and, for
    each layer (or once, unstacked), the port parameter, the rows of it
    that hold the leaf (None: all) and whether the leaf is its transpose."""

    path: str
    parts: list[tuple[nn.Parameter, slice | None, bool]]
    stacked: bool

    def gather(self, get=lambda p: p.detach()) -> torch.Tensor:
        """The leaf in the JAX layout from ``get(param)`` of each part (the
        parameter itself by default, or e.g. its gradient)."""
        views = []
        for p, rows, t in self.parts:
            v = get(p)
            v = v if rows is None else v[rows]
            views.append(v.t() if t else v)
        return torch.stack(views) if self.stacked else views[0]

    def write(self, get, value: torch.Tensor, add: bool = False) -> None:
        """Store (or with ``add``, add) ``value``, in the JAX layout, into
        ``get(param)`` of each part."""
        for i, (p, rows, t) in enumerate(self.parts):
            v = value[i] if self.stacked else value
            dst = get(p)
            dst = dst if rows is None else dst[rows]
            v = v.t() if t else v
            if add:
                dst.add_(v)
            else:
                dst.copy_(v)


def jax_leaves(model: CodonGPT, cfg: CodonGPTConfig) -> list[JaxLeaf]:
    """Every leaf of the JAX tree that ``model`` holds, in the module
    docstring's map."""
    leaves: list[JaxLeaf] = []

    def one(path, param, t=False):
        leaves.append(JaxLeaf(path, [(param, None, t)], False))

    def linear(path, lin):
        one(f"{path}/w", lin.weight, True)
        if lin.bias is not None:
            one(f"{path}/b", lin.bias)

    def stacked(path, lins, rows=None):
        # a weight is "w", or "w_q" and its "scale" on an Int8Linear
        if isinstance(lins[0], Int8Linear):
            weights = (("w_q", "w_q", True), ("scale", "scale", False))
        else:
            weights = (("w", "weight", True),)
        for jname, tname, t in weights + (("b", "bias", False),):
            if getattr(lins[0], tname) is not None:
                leaves.append(JaxLeaf(f"{path}/{jname}",
                                      [(getattr(lin, tname), rows, t) for lin in lins], True))

    def adapters(path, per_layer):
        for name in LORA_LEAVES:
            leaves.append(JaxLeaf(f"{path}/{name}",
                                  [(getattr(a, name), None, False) for a in per_layer], True))

    one("tok_emb", model.tok_emb.weight)
    if not cfg.use_rope:
        one("pos_emb", model.pos_emb.weight)
    blocks = list(model.blocks)
    for ln in ("ln1", "ln2"):
        for jname, tname in (("scale", "weight"), ("bias", "bias")):
            leaves.append(JaxLeaf(f"blocks/{ln}/{jname}",
                                  [(getattr(getattr(b, ln), tname), None, False)
                                   for b in blocks], True))
    per_block = [block_linears(b, cfg) for b in blocks]
    names = [("attn", n) for n in ATTN_LINEARS] + [("mlp", n) for n in MLP_LINEARS]
    for group, name in names:
        path = f"blocks/{group}/{name}"
        if (group, name) in per_block[0]:
            lins = [lb[(group, name)] for lb in per_block]
            stacked(path, lins)
            if "lora" in lins[0]._modules:
                adapters(path, [lin.lora for lin in lins])
        elif cfg.fused_qkv and group == "attn":  # rows of the fused linear
            c_q, c_kv = cfg.n_head * cfg.head_dim, cfg.kv_heads * cfg.head_dim
            lo = {"query": 0, "key": c_q, "value": c_q + c_kv}[name]
            rows = slice(lo, lo + (c_q if name == "query" else c_kv))
            stacked(path, [b.attn.qkv for b in blocks], rows)
            if "qkv_lora" in blocks[0].attn._modules:
                adapters(path, [b.attn.qkv_lora[name] for b in blocks])
    if cfg.moe_experts:  # the expert bank in JAX's layout, and the router
        for name, bank in blocks[0].mlp.named_children():
            for leaf in ("w", "b"):
                if getattr(bank, leaf) is not None:
                    leaves.append(JaxLeaf(
                        f"blocks/mlp/{name}/{leaf}",
                        [(getattr(getattr(b.mlp, name), leaf), None, False) for b in blocks],
                        True))
        leaves.append(JaxLeaf("blocks/router/w", [(b.router.w, None, False) for b in blocks],
                              True))
    one("ln_f/scale", model.ln_f.weight)
    one("ln_f/bias", model.ln_f.bias)
    if not cfg.tie_embeddings:
        linear("head", model.head)
    if cfg.termination_aux:
        linear("termination_head", model.termination_head)
    if cfg.use_shape_guidance:
        linear("shape_proj", model.shape_proj)
    for o in cfg.multi_offset_targets:
        linear(f"offset_projs/{o}/fc", model.offset_projs[str(o)][0])
        linear(f"offset_projs/{o}/proj", model.offset_projs[str(o)][2])
    encoder = model._modules.get("shape_encoder")
    if encoder is not None:
        for conv in ("conv1", "conv2"):
            one(f"shape_encoder/{conv}/w", getattr(encoder, conv).weight)
            one(f"shape_encoder/{conv}/b", getattr(encoder, conv).bias)
    return leaves


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, object]:
    """The tree's leaves by their "/"-joined paths."""
    out = {}
    for key, child in tree.items():
        path = f"{prefix}{key}"
        if isinstance(child, dict):
            out.update(flatten_tree(child, path + "/"))
        else:
            out[path] = child
    return out


def _quantize_layout(model: CodonGPT, quantized: set) -> None:
    """Make each block linear whose JAX (group, name) is in ``quantized``
    an empty ``Int8Linear`` (the fused QKV when query, key and value are)."""
    cfg = model.cfg
    qkv = {("attn", n) for n in ("query", "key", "value")}
    if cfg.fused_qkv and quantized & qkv:
        if not qkv <= quantized:
            raise ValueError("a fused QKV loads int8 query, key and value together, not "
                             f"{sorted(n for _, n in quantized & qkv)}")
        quantized = (quantized - qkv) | {("attn", "qkv")}
    for block in model.blocks:
        linears = block_linears(block, cfg, with_qkv=True)
        for key in quantized:
            if key not in linears:
                raise ValueError(f"the model has no block linear {key[0]}/{key[1]}")
            lin = linears[key]
            set_block_linear(block, cfg, *key, Int8Linear(
                lin.in_features, lin.out_features, lin.bias is not None).to(
                    lin.weight.device))


def attach_from_tree(model: CodonGPT, tree: dict) -> CodonGPT:
    """Give ``model`` the int8 linears, LoRA adapters and shape encoder
    that ``tree`` holds leaves for (their values stay to be loaded)."""
    blocks = tree.get("blocks", {})
    targets, rank, quantized = [], None, set()
    for group, names in (("attn", ATTN_LINEARS), ("mlp", MLP_LINEARS)):
        for name in names:
            node = blocks.get(group, {}).get(name, {})
            if isinstance(node, dict) and "lora_a" in node:
                targets.append((group, name))
                rank = int(np.shape(node["lora_a"])[-1])
            if isinstance(node, dict) and "w_q" in node:
                quantized.add((group, name))
    if quantized:
        _quantize_layout(model, quantized)
    if targets:
        attach_lora(model, targets, rank)
    if "shape_encoder" in tree:
        d_shape = int(np.shape(tree["shape_encoder"]["conv2"]["w"])[0])
        model.shape_encoder = ShapeEncoder(d_shape).to(model.tok_emb.weight.device)
    return model


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """The tree leaf ``a`` as a CPU tensor: int8 for an int8 parameter,
    else float32."""
    a = np.asarray(a)
    if dtype == torch.int8:
        if a.dtype != np.int8:
            raise ValueError(f"an int8 weight leaf holds {a.dtype}")
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))


def state_dict_from_jax(tree: dict, cfg: CodonGPTConfig) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a ``CodonGPT(cfg)`` carrying the JAX tree's
    weights (with the tree's adapters and shape encoder attached).

    A leaf that ``cfg`` needs and the tree lacks raises ``KeyError``; a
    leaf of the tree that ``cfg`` leaves unread (a head or a projection the
    config does not have, a router beside a dense MLP, a stray leaf) raises
    ``ValueError`` naming every one, and so does a leaf of another shape
    than the config's (an expert bank under a dense config): nothing is
    dropped or reshaped without a word.
    """
    with torch.device("meta"):
        skeleton = attach_from_tree(CodonGPT(cfg), tree)
    flat = flatten_tree(tree)
    leaves = jax_leaves(skeleton, cfg)
    unused = sorted(set(flat) - {leaf.path for leaf in leaves})
    if unused:
        raise ValueError(f"the tree has leaves this config has no place for: {unused}")
    names = {id(p): n for n, p in skeleton.named_parameters()}
    sd = {n: torch.empty(p.shape, dtype=torch.int8 if p.dtype == torch.int8 else torch.float32)
          for n, p in skeleton.named_parameters()}
    for leaf in leaves:
        if leaf.path not in flat and leaf.path.endswith("/lora_scale"):
            value = torch.ones(len(leaf.parts))  # an older tree: scale folded into lora_a
        else:
            value = _host_tensor(flat[leaf.path], leaf.parts[0][0].dtype)
            want = tuple(leaf.gather().shape)
            if tuple(value.shape) != want:
                raise ValueError(f"the tree's {leaf.path} has shape {tuple(value.shape)}; "
                                 f"this config holds {want}")
        leaf.write(lambda p: sd[names[id(p)]], value)
    return sd


def params_from_jax(tree: dict, cfg: CodonGPTConfig,
                    device: str | torch.device) -> CodonGPT:
    """A ``CodonGPT`` on ``device`` holding the JAX tree's weights (float32,
    and int8 ``Int8Linear`` weights where the tree is quantized), its
    adapters and shape encoder included.

    Every key must match: a leaf missing from the tree, or one the port
    has no place for, raises.
    """
    model = attach_from_tree(CodonGPT(cfg), tree)
    model.load_state_dict(state_dict_from_jax(tree, cfg), strict=True)
    return model.to(device).eval()


def params_to_jax(model: CodonGPT, cfg: CodonGPTConfig) -> dict:
    """The JAX parameter tree (nested dicts of numpy arrays: float32, and
    int8 for ``w_q``) that carries ``model``'s weights: the inverse of
    ``params_from_jax``.

    Per-layer leaves stack on a leading L axis, linear weights transpose to
    (in, out), and a fused QKV linear splits back into query, key and
    value.
    """
    tree: dict = {}
    for leaf in jax_leaves(model, cfg):
        node = tree
        *parents, name = leaf.path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        value = leaf.gather().cpu()
        node[name] = (value if value.dtype == torch.int8 else value.float()).numpy().copy()
    return tree


# --- the protein stack (``models/protein.py``) ---------------------------------
#
# The protein modules hold their parameters under the JAX tree's names and
# layouts (``w`` (fan_in, fan_out), ``b``, ``scale``, blocks a list), so a
# state_dict key is the JAX path with dots and no leaf transposes.

PROTEIN_KINDS = ("lm", "classifier", "multitask", "ebm")


def _flatten_with_lists(tree, prefix: str = "") -> dict[str, object]:
    """A tree's leaves by dotted path, list items by their index."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, child in items:
        out.update(_flatten_with_lists(child, f"{prefix}.{key}" if prefix else str(key)))
    return out


def protein_module(kind: str, cfg, tree: dict | None = None) -> nn.Module:
    """An empty protein module of ``kind`` for ``cfg``; the multi-task heads
    and the EBM's widths are read from ``tree`` where it has them."""
    from genomics_lm_torch.models import protein as pm

    if kind == "lm":
        return pm.ProteinLM(cfg)
    if kind == "classifier":
        return pm.ProteinClassifier(cfg)
    if kind == "multitask":
        heads = (tree or {}).get("heads", {})
        return pm.MultiTaskProteinCritic(
            cfg, {name: int(np.shape(h["w"])[1]) for name, h in heads.items()})
    if kind == "ebm":
        fc1 = np.shape(tree["fc1"]["w"])
        return pm.ProteinLatentEBM(int(fc1[0]), int(fc1[1]))
    raise ValueError(f"unknown protein model kind {kind!r}; one of {PROTEIN_KINDS}")


def protein_params_from_jax(tree: dict, kind: str, cfg, device: str | torch.device) -> nn.Module:
    """A protein module (``kind`` in ``PROTEIN_KINDS``) on ``device`` holding
    the JAX tree's weights in float32. ``cfg`` is the ``ProteinLMConfig``
    (``lm``) or ``ProteinClassifierConfig``; the EBM needs none. A leaf the
    module needs and the tree lacks, a leaf the module has no place for, and
    a leaf of another shape raise."""
    model = protein_module(kind, cfg, tree)
    flat = _flatten_with_lists(tree)
    sd = model.state_dict()
    missing = sorted(set(sd) - set(flat))
    unused = sorted(set(flat) - set(sd))
    if missing:
        raise KeyError(f"the tree lacks leaves this {kind} model needs: {missing}")
    if unused:
        raise ValueError(f"the tree has leaves this {kind} model has no place for: {unused}")
    for key, want in sd.items():
        value = _host_tensor(flat[key], torch.float32)
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"the tree's {key} has shape {tuple(value.shape)}; "
                             f"this {kind} model holds {tuple(want.shape)}")
        sd[key] = value
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def protein_params_to_jax(model: nn.Module) -> dict:
    """The JAX tree (nested dicts of float32 numpy arrays, blocks a list) of a
    protein module: the inverse of ``protein_params_from_jax``."""
    tree: dict = {}
    for key, value in model.state_dict().items():
        node = tree
        *parents, name = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = value.detach().float().cpu().numpy().copy()

    def lists(node):  # a node keyed 0..n-1 is the JAX tree's list
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)

__all__ = [
    "JaxLeaf",
    "attach_from_tree",
    "flatten_tree",
    "jax_leaves",
    "params_from_jax",
    "params_to_jax",
    "PROTEIN_KINDS",
    "protein_module",
    "protein_params_from_jax",
    "protein_params_to_jax",
    "state_dict_from_jax",
]
