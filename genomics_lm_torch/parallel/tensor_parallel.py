"""Megatron tensor and sequence parallelism over the model axis.

JAX gets tensor parallelism from GSPMD: the parameters carry the
``tp_spec`` shardings and XLA inserts the collectives. Here each rank of
the model axis holds its slice of every split parameter
(``shard_model``) and the forward calls the collectives itself, as
``torch.autograd.Function``s (Megatron's f/g pair):

- ``copy_to_tp`` at a column-parallel entry: identity forward, all-reduce
  of the input gradient backward (each rank's heads give part of it);
- ``reduce_from_tp`` at a row-parallel exit: all-reduce of the partial
  sums forward, identity backward.

Under sequence parallelism (``residual_sharding = ("data", "model")``, JAX's
``_constrain_residual``) the residual stream between the column entries and
the row exits lives split over the sequence axis T:

- ``gather_seq`` at a column entry: all-gather on T forward, reduce-scatter
  on T backward;
- ``reduce_scatter_seq`` at a row exit: reduce-scatter on T forward,
  all-gather backward;
- ``split_seq`` / ``gather_seq_replicated`` where the stream enters and
  leaves the blocks (after the embedding, before the final norm): a slice
  forward and an all-gather backward, and the reverse.

Attention is head-local, so the attention kernels run per rank on their
local heads with no collective. Expert parallelism shares the model axis
(JAX's ``moe_param_sharding`` with ``tp_axis`` the same axis): a rank holds
its experts of every MoE block, and the expert MLP enters and leaves
through the same f/g pair as a split dense MLP (``models/codon_gpt.py::
_moe_mlp``). ``TPContext`` carries the model axis's
group, this rank's index and size, and ``layout`` (``parallel/
sharding.py::tp_layout``). The forward reads it from ``block.tp`` and
``model.tp`` (None: no tensor parallelism). Parameters the rules replicate
but that act on heads (LoRA factors, int8 ``w_q``/``scale``) are sliced at
use by the linear's ``tp_index``: ("col", output indices) or ("row", input
indices) of this rank's heads.

Every collective takes a contiguous tensor; a CUDA tensor on a card that
several ranks share goes over gloo, which carries all of these on CUDA
tensors.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from genomics_lm_torch.parallel.launch import timed
from genomics_lm_torch.parallel.mesh import MODEL_AXIS, Mesh
from genomics_lm_torch.parallel.sharding import Split, tp_layout


@dataclass
class TPContext:
    group: object
    rank: int
    size: int
    sequence_parallel: bool = False
    layout: dict = field(default_factory=dict)

    @classmethod
    def from_mesh(cls, mesh: Mesh, *, sequence_parallel: bool = False) -> "TPContext":
        return cls(mesh.group(MODEL_AXIS), mesh.axis_rank(MODEL_AXIS),
                   mesh.axis_size(MODEL_AXIS), sequence_parallel)


def _nbytes(x: torch.Tensor, times: int = 1) -> int:
    return times * x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    with timed(x.device, _nbytes(x)):
        dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, ctx: TPContext) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.size)]
    with timed(x.device, _nbytes(x, ctx.size), "all-gather"):
        dist.all_gather(parts, x, group=ctx.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, ctx: TPContext) -> torch.Tensor:
    chunks = [c.contiguous() for c in x.chunk(ctx.size, dim=dim)]
    out = torch.empty_like(chunks[ctx.rank])
    with timed(x.device, _nbytes(out), "reduce-scatter"):
        dist.reduce_scatter(out, chunks, group=ctx.group)
    return out


def _slice(x: torch.Tensor, dim: int, ctx: TPContext) -> torch.Tensor:
    return x.chunk(ctx.size, dim=dim)[ctx.rank].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, grad):
        return _all_reduce(grad, fctx.ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return _all_reduce(x, ctx.group)

    @staticmethod
    def backward(fctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    """All-gather on T; backward reduce-scatter (``partial``: the consumer
    is column-parallel, each rank's gradient a partial sum) or slice (the
    consumer is replicated, every rank's gradient the whole one)."""

    @staticmethod
    def forward(fctx, x, ctx, partial):
        fctx.ctx, fctx.partial = ctx, partial
        return _all_gather(x, 1, ctx)

    @staticmethod
    def backward(fctx, grad):
        if fctx.partial:
            return _reduce_scatter(grad, 1, fctx.ctx), None, None
        return _slice(grad, 1, fctx.ctx), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _reduce_scatter(x, 1, ctx)

    @staticmethod
    def backward(fctx, grad):
        return _all_gather(grad, 1, fctx.ctx), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _slice(x, 1, ctx)

    @staticmethod
    def backward(fctx, grad):
        return _all_gather(grad, 1, fctx.ctx), None


def copy_to_tp(x, ctx: TPContext):
    return _CopyToTP.apply(x, ctx)


def reduce_from_tp(x, ctx: TPContext):
    return _ReduceFromTP.apply(x, ctx)


def gather_seq(x, ctx: TPContext):
    return _GatherSeq.apply(x, ctx, True)


def gather_seq_replicated(x, ctx: TPContext):
    return _GatherSeq.apply(x, ctx, False)


def reduce_scatter_seq(x, ctx: TPContext):
    return _ReduceScatterSeq.apply(x, ctx)


def split_seq(x, ctx: TPContext):
    return _SplitSeq.apply(x, ctx)


def enter(x, ctx: TPContext | None, seq: bool):
    """A column-parallel entry: the input every rank's heads read."""
    if ctx is None:
        return x
    return gather_seq(x, ctx) if seq else copy_to_tp(x, ctx)


def exit_(x, ctx: TPContext | None, seq: bool):
    """A row-parallel exit: the partial sums of every rank's heads, summed."""
    if ctx is None:
        return x
    return reduce_scatter_seq(x, ctx) if seq else reduce_from_tp(x, ctx)


def broadcast_(x: torch.Tensor, ctx: TPContext | None) -> torch.Tensor:
    """``x`` from the model axis's rank 0 on every rank of it (in place)."""
    if ctx is not None and ctx.size > 1:
        with timed(x.device, _nbytes(x), "broadcast"):
            dist.broadcast(x, group_src=0, group=ctx.group)
    return x


def _index(split: Split, ctx: TPContext, device):
    idx = split.local_index(ctx.rank, ctx.size)
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return slice(idx[0], idx[0] + len(idx))
    return torch.tensor(idx, dtype=torch.long, device=device)


def take(t: torch.Tensor, dim: int, index) -> torch.Tensor:
    """``t``'s entries ``index`` (a slice or an index tensor) along ``dim``."""
    if isinstance(index, slice):
        return t.narrow(dim, index.start, index.stop - index.start)
    return t.index_select(dim, index.to(t.device))


def tp_local_config(cfg, size: int):
    """The config of one rank's attention: its heads (``n_head``/``size``,
    ``kv_heads``/``size``) and their width, the head size unchanged. The
    decode paths size their caches and reshapes by it."""
    if size <= 1:
        return cfg
    return cfg.replace(n_head=cfg.n_head // size, n_kv_head=cfg.kv_heads // size,
                       n_embd=cfg.n_embd // size)


def check_tp(cfg, size: int) -> None:
    if cfg.kv_heads % size or cfg.n_head % size:
        raise ValueError(
            f"kv_heads {cfg.kv_heads} / n_head {cfg.n_head} must divide over model={size}")


@torch.no_grad()
def shard_model(model, ctx: TPContext, *, copy_model: bool = False):
    """Split ``model`` (a full ``CodonGPT``) for rank ``ctx.rank`` of the
    model axis, in place (or a deep copy with ``copy_model``): every
    parameter the rules split keeps this rank's slice; every block linear
    gets its ``tp_index``; the MLP is split only when the degree divides its
    hidden width (else it runs replicated, as JAX's rules leave it). A MoE
    block's expert bank splits by experts when the degree divides E (expert
    parallelism: ``block.mlp.experts`` is then this rank's (first expert,
    count)), else it runs replicated, as ``moe_param_sharding`` falls back."""
    from genomics_lm_torch.models.codon_gpt import block_linears
    from genomics_lm_torch.parallel.sharding import expert_split

    cfg = model.cfg
    check_tp(cfg, ctx.size)
    if copy_model:
        model = copy.deepcopy(model)
    rs = cfg.residual_sharding
    if rs is not None and len(rs) > 1 and rs[1] == MODEL_AXIS:
        ctx.sequence_parallel = True
    ctx.layout = tp_layout(model, cfg, ctx.size)
    hd = cfg.head_dim
    c_q, c_kv = cfg.n_head * hd, cfg.kv_heads * hd
    mlp_split = cfg.mlp_hidden % ctx.size == 0
    for block in model.blocks:
        block.tp = ctx
        for (group, name), lin in block_linears(block, cfg, with_qkv=True).items():
            if group == "mlp" and not mlp_split:
                continue
            dev = next(lin.parameters()).device
            if name == "qkv":
                split = Split(0, (c_q, c_kv, c_kv))
                adapters = block.attn._modules.get("qkv_lora")
                if adapters is not None:
                    for n, a in adapters.items():
                        size = c_q if n == "query" else c_kv
                        a.tp_index = ("col", _index(Split(0, (size,)), ctx, dev))
            elif name in ("proj", "w_down"):
                in_features = (lin.w_q if hasattr(lin, "w_q") else lin.weight).shape[1]
                split = Split(1, (in_features,))
            else:
                out_features = (lin.w_q if hasattr(lin, "w_q") else lin.weight).shape[0]
                split = Split(0, (out_features,))
            lin.tp_index = ("col" if split.dim == 0 else "row", _index(split, ctx, dev))
    for i, block in enumerate(model.blocks):
        if cfg.moe_experts and expert_split(f"blocks.{i}.", ctx.layout):
            local = cfg.moe_experts // ctx.size
            block.mlp.experts = (ctx.rank * local, local)
    for name, p in model.named_parameters():
        split = ctx.layout.get(name)
        if split is not None:
            idx = _index(split, ctx, p.device)
            p.data = take(p.data, split.dim, idx).clone()
    model.tp = ctx
    return model


def assemble(parts: list[torch.Tensor], split: Split, tp: int) -> torch.Tensor:
    """The full tensor from the ``tp`` ranks' slices (``parts[r]`` is rank
    r's), the inverse of ``shard_model``'s slicing."""
    shape = list(parts[0].shape)
    shape[split.dim] = sum(split.blocks)
    full = parts[0].new_empty(shape)
    for r, part in enumerate(parts):
        idx = torch.tensor(split.local_index(r, tp), dtype=torch.long, device=part.device)
        full.index_copy_(split.dim, idx, part)
    return full


@torch.no_grad()
def load_full_state(model, state_dict: dict) -> None:
    """Load a full (unsplit) state dict: into a tensor-parallel model each
    split parameter takes its rank's slice; else ``load_state_dict``."""
    ctx = getattr(model, "tp", None)
    if ctx is None:
        model.load_state_dict(state_dict, strict=True)
        return
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state_dict))
    unknown = sorted(set(state_dict) - set(params))
    if missing or unknown:
        raise RuntimeError(f"state dict: missing {missing}, unexpected {unknown}")
    for name, p in params.items():
        full = torch.as_tensor(state_dict[name])
        split = ctx.layout.get(name)
        if split is not None:
            full = take(full, split.dim, _index(split, ctx, full.device))
        p.copy_(full)


def local_slice(t: torch.Tensor, split: Split | None, ctx: TPContext | None) -> torch.Tensor:
    """This rank's slice of a full tensor laid out as a parameter (e.g. a
    moment), or the tensor itself when it is not split."""
    if ctx is None or split is None:
        return t
    return take(t, split.dim, _index(split, ctx, t.device)).clone()


__all__ = [
    "TPContext",
    "assemble",
    "broadcast_",
    "check_tp",
    "copy_to_tp",
    "enter",
    "exit_",
    "gather_seq",
    "gather_seq_replicated",
    "load_full_state",
    "local_slice",
    "reduce_from_tp",
    "reduce_scatter_seq",
    "shard_model",
    "split_seq",
    "take",
    "tp_local_config",
]
