"""Sharding rules (twin of ``genomics_lm_tpu/parallel/sharding.py``).

JAX's tensor-parallel rule is a function of a leaf's tree path and shape
that returns a ``PartitionSpec``; ``tp_spec`` keeps it as it is, over the
JAX layout, with a spec a tuple of axis names. The spec-tree helpers JAX
hands to ``jax.device_put`` (``tp_param_sharding``, ``opt_state_sharding``,
``zero1_opt_state_sharding``, ``replicated``, ``batch_sharding``) have no
counterpart: here each rank holds its parameters' slices (``tp_layout``),
its moments (``zero1_owners``) and its rows of the batch itself.

The port holds a model as ``nn.Linear``s of shape (out, in), one per layer,
where JAX stacks (L, fan_in, fan_out). ``tp_layout`` maps the rules onto
the port's parameters through the same layout map as
``utils/weights.py::params_from_jax`` (``jax_leaves``): a JAX column split
of the last axis is the port's dimension 0, a row split of fan_in its
dimension 1, and a fused ``attn.qkv`` takes its heads' rows of each of the
query, key and value blocks (``Split.blocks``), not a contiguous slice of
the concatenation. JAX replicates the LoRA factors and the int8 ``w_q`` /
``scale`` leaves (their path ends in neither ``w`` nor ``b``), and so does
the port: a rank computes with its heads' slice of them at use
(``parallel/tensor_parallel.py``).

Expert parallelism (``ep_spec``, JAX's ``:134-176``): on a MoE config the
rule is ``moe_param_sharding``'s choice. When the model axis divides the
expert count E, every expert-stacked leaf (``blocks/mlp/...``, whose
second axis is E) splits its E axis, so a rank of the axis holds experts
``[r·E/ep, (r+1)·E/ep)`` of every layer (the port's dimension 0 of an
``ExpertLinear``); the router and every other leaf replicate, and the
attention leaves take the Megatron split over the same axis. When the
axis does not divide E, the experts replicate (JAX's fallback) and only
the attention splits.

ZeRO-1 (``zero1_owners``) splits the optimizer state by ownership instead
of JAX's per-leaf axis split: each unit of parameters (one parameter, or
the parameters that share a JAX leaf) belongs to one data-parallel rank,
which alone holds its moments and computes its update; the units are dealt
out largest first to the least loaded rank, so each rank holds about 1/dp
of the moments. The update and the saved state are JAX's; only the place
each moment lives differs.
"""

from __future__ import annotations

from dataclasses import dataclass

from genomics_lm_torch.parallel.mesh import MODEL_AXIS


class PartitionSpec(tuple):
    """One entry per array axis: a mesh axis name, or None (not split)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


# --- Tensor parallelism (Megatron column/row splits) -------------------------
#
# Column-parallel weights (QKV, MLP up/gate) split their fan-out; row-parallel
# weights (attention output proj, MLP down) split their fan-in, and the
# partial sums meet in an all-reduce (a reduce-scatter under sequence
# parallelism). Embeddings, layer norms and the heads replicate. A rule whose
# dimension the degree does not divide replicates that leaf.

_COLUMN_SUFFIXES = (
    ("attn", "query"),
    ("attn", "key"),
    ("attn", "value"),
    ("mlp", "w_gate"),
    ("mlp", "w_up"),
    ("mlp", "fc"),
)
_ROW_SUFFIXES = (
    ("attn", "proj"),
    ("mlp", "w_down"),
    ("mlp", "proj"),
)


def tp_spec(path_names: tuple[str, ...], shape, tp: int, axis: str) -> PartitionSpec:
    """PartitionSpec of one JAX-layout leaf under tensor parallelism (or
    replication); ``path_names`` is its tree path, and the rules match on
    the module suffix, so they apply to moment trees that mirror it too."""
    if tp <= 1 or len(shape) == 0:
        return P()
    if path_names and path_names[-1] in ("w", "b"):
        suffix, leaf = tuple(path_names[-3:-1]), path_names[-1]
    else:
        suffix, leaf = tuple(path_names[-2:]), "w"

    if suffix in _COLUMN_SUFFIXES:
        dim = len(shape) - 1  # (L, fan_in, fan_out): fan_out; bias (L, fan_out) too
        if shape[dim] % tp == 0:
            spec = [None] * len(shape)
            spec[dim] = axis
            return P(*spec)
        return P()
    if suffix in _ROW_SUFFIXES:
        if leaf == "b":  # a row-parallel bias is added after the reduction
            return P()
        dim = len(shape) - 2  # (L, fan_in, fan_out): fan_in
        if dim >= 0 and shape[dim] % tp == 0:
            spec = [None] * len(shape)
            spec[dim] = axis
            return P(*spec)
        return P()
    return P()


def ep_spec(path_names: tuple[str, ...], shape, ep: int, axis: str,
            n_experts: int) -> PartitionSpec | None:
    """PartitionSpec of one JAX-layout leaf under expert parallelism, or
    None (no expert rule: the caller falls back to ``tp_spec`` or
    replication): a leaf under ``mlp`` whose axis 1 (after the layer stack)
    is the E experts splits it, when ``ep`` divides E."""
    if ep <= 1 or n_experts % ep or "mlp" not in path_names:
        return None
    if len(shape) >= 2 and shape[1] == n_experts:
        spec = [None] * len(shape)
        spec[1] = axis
        return P(*spec)
    return None


def model_axis_spec(path_names: tuple[str, ...], shape, tp: int, n_experts: int
                    ) -> PartitionSpec:
    """The model axis's spec of a leaf: ``tp_spec`` on a dense config; on a
    MoE config ``moe_param_sharding``'s choice, the expert rule first and
    ``tp_spec`` only outside the MLP (an expert bank that the degree does
    not divide replicates)."""
    if not n_experts:
        return tp_spec(path_names, shape, tp, MODEL_AXIS)
    spec = ep_spec(path_names, shape, tp, MODEL_AXIS, n_experts)
    if spec is None and "mlp" not in path_names:
        spec = tp_spec(path_names, shape, tp, MODEL_AXIS)
    return spec if spec is not None else P()


# --- The rules on the port's parameters --------------------------------------


@dataclass(frozen=True)
class Split:
    """How a port parameter splits over the model axis: along ``dim``, in
    ``blocks`` (the sizes along ``dim`` of consecutive blocks, each of which
    splits evenly; a rank takes its part of every block)."""

    dim: int
    blocks: tuple[int, ...]

    def local_index(self, rank: int, tp: int) -> list[int]:
        """The indices along ``dim`` that rank ``rank`` of ``tp`` holds."""
        out, start = [], 0
        for size in self.blocks:
            part = size // tp
            out.extend(range(start + rank * part, start + (rank + 1) * part))
            start += size
        return out


def tp_layout(model, cfg, tp: int) -> dict[str, Split | None]:
    """Each parameter name of ``model`` (a full, unsplit ``CodonGPT``) →
    its ``Split`` under a ``tp``-wide model axis, or None (replicated), by
    ``model_axis_spec`` on the JAX leaves that ``jax_leaves`` maps it to:
    the Megatron split, and on a MoE config the expert split."""
    from genomics_lm_torch.utils.weights import jax_leaves

    names = {id(p): n for n, p in model.named_parameters()}
    per_param: dict[str, list] = {}
    for leaf in jax_leaves(model, cfg):
        for p, rows, t in leaf.parts:
            shape = tuple(p[rows].shape if rows is not None else p.shape)
            jshape = tuple(reversed(shape)) if t else shape
            if leaf.stacked:
                jshape = (len(leaf.parts),) + jshape
            spec = model_axis_spec(tuple(leaf.path.split("/")), jshape, tp,
                                   cfg.moe_experts)
            dim = next((d for d, a in enumerate(spec) if a is not None), None)
            if dim is not None:
                dim -= 1 if leaf.stacked else 0
                if t:
                    dim = len(shape) - 1 - dim
            per_param.setdefault(names[id(p)], []).append((rows, dim, shape))
    layout: dict[str, Split | None] = {}
    for name, _ in model.named_parameters():
        entries = per_param.get(name, [])
        dims = {d for _, d, _ in entries}
        if not entries or dims == {None}:
            layout[name] = None
            continue
        if len(dims) != 1:
            raise ValueError(f"{name}: its JAX leaves split on different axes {dims}")
        dim = dims.pop()
        blocks = tuple(shape[dim] for _, _, shape in
                       sorted(entries, key=lambda e: 0 if e[0] is None else e[0].start))
        layout[name] = Split(dim, blocks)
    return layout


def tp_partial_grad(name: str, layout: dict, *, sequence_parallel: bool) -> bool:
    """Whether a replicated parameter's gradient is a partial sum over the
    model axis (each rank saw only its heads or its tokens), to be summed
    there: the LoRA factors (used through their heads' slice), and under
    sequence parallelism the block layer norms and the biases of split
    row-parallel linears (applied to each rank's slice of the sequence).
    Under expert parallelism the router's too: each rank's combine sees only
    its experts' gates (its router-loss term is scaled to 1/ep a rank,
    ``models/codon_gpt.py::_moe_mlp``)."""
    if "lora_a" in name or "lora_b" in name:
        return True
    if name.endswith(".router.w"):
        return expert_split(name[: -len("router.w")], layout)
    if not sequence_parallel or not name.startswith("blocks.") or layout.get(name):
        return False
    parts = name.split(".")
    if parts[2] in ("ln1", "ln2"):
        return True
    weight = name[: -len("bias")] + "weight"
    return (parts[-1] == "bias" and parts[2:4] in (["attn", "proj"], ["mlp", "2"])
            and layout.get(weight) is not None)


def expert_split(block_prefix: str, layout: dict) -> bool:
    """Whether the expert bank of the block ``block_prefix`` ("blocks.3.")
    is split over the model axis (expert parallelism)."""
    return any(layout.get(f"{block_prefix}mlp.{bank}.w") is not None
               for bank in ("fc", "w_up"))


def zero1_owners(units: list[tuple[str, int]], dp: int) -> dict[str, int]:
    """Deal ``units`` (name, element count) to ``dp`` data-parallel ranks,
    largest first to the least loaded (ties to the lower rank, then the
    earlier unit): name → owning rank. The same on every rank."""
    load = [0] * dp
    owner = {}
    order = sorted(range(len(units)), key=lambda i: (-units[i][1], i))
    for i in order:
        name, size = units[i]
        r = min(range(dp), key=lambda k: (load[k], k))
        owner[name] = r
        load[r] += size
    return owner


__all__ = [
    "P",
    "ep_spec",
    "expert_split",
    "model_axis_spec",
    "PartitionSpec",
    "Split",
    "tp_layout",
    "tp_partial_grad",
    "tp_spec",
    "zero1_owners",
]
