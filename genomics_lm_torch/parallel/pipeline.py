"""GPipe pipeline parallelism over a ``pipe`` mesh axis (twin of
``genomics_lm_tpu/parallel/pipeline.py``).

JAX runs the GPipe schedule as one SPMD program: ``shard_map`` over the
``pipe`` axis, ``lax.scan`` over the ticks, ``ppermute`` between the
stages, and reverse-mode AD through all of it. Here each rank of the
``pipe`` axis is a process that holds one stage, and the schedule is
written out:

- A stage builds only its blocks, layers ``[s·Lps, (s+1)·Lps)``
  (``stage_model``); the embedding, ``ln_f`` and the head stay replicated
  on every stage, as JAX keeps them (``:105-132``). ``split_stage_params``
  and ``merge_stage_params`` map between the full state and a stage's, by
  parameter name (a state dict, or the optimizer state keyed by name), so
  checkpoints hold the merged layout and resume under any stage count.
- The group step (``make_pipeline_group_step``) runs the M = G microbatches
  forward: stage 0 embeds, each stage applies its blocks and sends its
  output to stage s+1, and the last stage applies ``ln_f``, the head and
  ``cross_entropy_parts``. Then the M backwards, in reverse, each sending
  the gradient of the stage's input to stage s−1. The loss is JAX's exact
  whole-group, token-weighted CE: Σ numer / Σ denom over the group and the
  data axis. The denominator is known from the targets before the
  forwards, so each microbatch's backward starts from its
  ``numer_m / denom``.
- The replicated parameters' gradients (the embedding on stage 0 and, when
  tied, again on the last stage's head; ``ln_f`` and the head there) are
  summed over the ``pipe`` axis before the data axis's reduction, as the
  ``shard_map`` transpose sums them (``:29-33``); every stage then applies
  the same update to its copy.
- A ``model`` axis is Megatron tensor (and sequence) parallelism inside
  each stage: a stage's blocks take ``tensor_parallel.shard_model``'s
  splits, and the stream between stages is each rank's (a slice of T under
  sequence parallelism). A ``data`` axis holds each rank's strided rows of
  every microbatch; ZeRO-1 deals a stage's moments over its data ranks.
- Dropout: JAX folds its key per (stage, tick, data index) (``:229-239``),
  a stream no other layout reproduces. Here each group draws one seed from
  the trainer's generator (seeded per data rank), and microbatch m of stage
  s draws from a generator seeded by (that seed, s, m).

The transport: NCCL, where each rank has its own card, sends the stream's
tensors between neighbours as they are. Ranks that share one card run gloo
(NCCL refuses them), whose ``send``/``recv`` PyTorch lists for CPU tensors
only; on an H100, gloo's ``send`` of a CUDA tensor aborts the sending
process (``writev ... Bad address``). So under gloo a CUDA activation is
staged through host memory: a copy to the host, the send, and a copy back
to the card on the receiver. The neighbour exchange is never silently
skipped or replaced.

Each exchange goes through ``launch.timed`` as a ``collective-permute``
(JAX's name for the ``ppermute``): its bytes are counted, and its time
when timing is on.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from genomics_lm_torch.ops.losses import PAD_ID, cross_entropy_parts
from genomics_lm_torch.parallel.mesh import PIPE_AXIS, Mesh

_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")


@dataclass
class PPContext:
    """The ``pipe`` axis seen from one rank: its group, its stage ``rank``
    of ``size``, the global ranks of its neighbours (None at either end),
    the collective backend, and the stage's first layer and layer count."""

    group: object
    rank: int
    size: int
    prev: int | None
    next: int | None
    backend: str
    first_layer: int
    layers: int

    @classmethod
    def from_mesh(cls, mesh: Mesh, n_layer: int) -> "PPContext":
        s, S = mesh.axis_rank(PIPE_AXIS), mesh.axis_size(PIPE_AXIS)
        first, count = stage_layers(n_layer, S, s)
        # this rank's line of the pipe axis: the global ranks of every stage
        ax = mesh.axis_names.index(PIPE_AXIS)
        coords = [mesh.axis_rank(name) for name in mesh.axis_names]
        line = [int(mesh.devices[tuple(coords[:ax] + [i] + coords[ax + 1:])])
                for i in range(S)]
        return cls(mesh.group(PIPE_AXIS), s, S, line[s - 1] if s > 0 else None,
                   line[s + 1] if s < S - 1 else None, dist.get_backend(), first, count)

    @property
    def is_first(self) -> bool:
        return self.rank == 0

    @property
    def is_last(self) -> bool:
        return self.rank == self.size - 1


def stage_layers(n_layer: int, n_stages: int, stage: int) -> tuple[int, int]:
    """(first layer, layers per stage) of ``stage``; JAX's ``ValueError``
    when the stage count does not divide the layers."""
    if n_layer % n_stages:
        raise ValueError(f"n_layer={n_layer} not divisible by n_stages={n_stages}")
    per = n_layer // n_stages
    return stage * per, per


def split_stage_params(state: dict, n_layer: int, n_stages: int, stage: int) -> dict:
    """The entries of the full ``state`` (keyed by parameter name) that
    stage ``stage`` of ``n_stages`` holds: every non-block entry, and its
    blocks' entries renumbered from 0 (``blocks.{s·Lps + i}.x`` →
    ``blocks.{i}.x``)."""
    first, per = stage_layers(n_layer, n_stages, stage)
    out = {}
    for name, value in state.items():
        m = _BLOCK.match(name)
        if m is None:
            out[name] = value
        elif first <= int(m.group(1)) < first + per:
            out[f"blocks.{int(m.group(1)) - first}.{m.group(2)}"] = value
    return out


def stage_to_full(state: dict, stage: int, layers: int) -> dict:
    """Stage ``stage``'s entries (``layers`` blocks a stage) under their
    full names: ``blocks.{i}.x`` → ``blocks.{stage·layers + i}.x``."""
    out = {}
    for name, value in state.items():
        m = _BLOCK.match(name)
        out[name if m is None else f"blocks.{stage * layers + int(m.group(1))}.{m.group(2)}"] = value
    return out


def merge_stage_params(stages: list[dict], layers: int) -> dict:
    """The inverse of ``split_stage_params``: the full state from every
    stage's (``stages[s]`` is stage s's, ``layers`` blocks a stage); the
    non-block entries are stage 0's (every stage holds the same)."""
    out = {}
    for s, state in reversed(list(enumerate(stages))):
        out.update(stage_to_full(state, s, layers))
    return out


def split_stage_leaves(state: dict, first: int, layers: int) -> dict:
    """A stage's part of ``state`` keyed by JAX leaf path (Adafactor's
    statistics): layers [first, first + layers) of each stacked leaf's
    (``blocks/...``) arrays, every other leaf's whole."""
    return {path: ({k: np.asarray(v)[first: first + layers] for k, v in st.items()}
                   if path.startswith("blocks/") else st)
            for path, st in state.items()}


def merge_stage_leaves(stages: list[dict]) -> dict:
    """The inverse of ``split_stage_leaves`` over every stage's state
    (``stages[s]`` is stage s's): each stacked leaf's arrays joined on their
    layer axis, every other leaf stage 0's."""
    return {path: ({k: np.concatenate([np.asarray(s[path][k]) for s in stages])
                    for k in st} if path.startswith("blocks/") else st)
            for path, st in stages[0].items()}


def assemble_pieces(pieces: list, key: str, layout: dict, pp: PPContext | None) -> dict:
    """The full state (by parameter name) from the ranks' pieces, each
    ``{"tp": model-axis rank, "stage": pipe rank, key: {name: tensor}}`` or
    None (a rank that sends nothing): each stage's parameters split over
    the model axis (``layout``, by a stage's names) joined, then the stages
    merged."""
    from genomics_lm_torch.parallel import tensor_parallel as tpl

    stages = []
    for s in range(pp.size if pp is not None else 1):
        parts = {pc["tp"]: pc[key] for pc in pieces
                 if pc is not None and pc[key] is not None and pc["stage"] == s}
        n_tp = len(parts)
        stages.append({n: (tpl.assemble([parts[t][n] for t in range(n_tp)], split, n_tp)
                           if (split := layout.get(n)) is not None else v)
                       for n, v in parts[0].items()})
    return stages[0] if pp is None else merge_stage_params(stages, pp.layers)


def stage_model(model, pp: PPContext):
    """Keep only ``pp``'s blocks of ``model`` (a full ``CodonGPT``), in
    place; ``model.pp`` carries the axis."""
    blocks = list(model.blocks)[pp.first_layer: pp.first_layer + pp.layers]
    model.blocks = torch.nn.ModuleList(blocks)
    model.pp = pp
    return model


def timed(*args):
    # imported at use: the package imports this module, and ``launch`` runs
    # as ``python -m genomics_lm_torch.parallel.launch``
    from genomics_lm_torch.parallel.launch import timed as count

    return count(*args)


def _send(t: torch.Tensor, to: int, pp: PPContext) -> None:
    t = t.detach().contiguous()
    if pp.backend == "gloo" and t.is_cuda:  # gloo's point to point: host tensors
        t = t.cpu()
    with timed(t.device, t.numel() * t.element_size(), "collective-permute"):
        dist.send(t, dst=to)


def _recv(shape, dtype, device, src: int, pp: PPContext) -> torch.Tensor:
    device = torch.device(device)
    host = pp.backend == "gloo" and device.type == "cuda"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    with timed(device, buf.numel() * buf.element_size(), "collective-permute"):
        dist.recv(buf, src=src)
    return buf.to(device) if host else buf


def _stream_shape(model, cfg, idx: torch.Tensor) -> tuple[int, int, int]:
    from genomics_lm_torch.models.codon_gpt import _sequence_parallel

    B, T = idx.shape
    seq = _sequence_parallel(model, idx)
    return (B, T // seq.size if seq is not None else T, cfg.n_embd)


def _ce_weight(cfg, device):
    return (None if cfg.uniform_loss_weights
            else torch.tensor(cfg.loss_weights, dtype=torch.float32, device=device))


def _microbatch_generators(generator, pp: PPContext, M: int, device):
    """Microbatch m's dropout generator on this stage: seeded by (one draw
    of the trainer's ``generator`` a group, the stage, m)."""
    if generator is None:
        return [None] * M
    base = int(torch.randint(0, 2**62, (1,), generator=generator, device=device).item())
    out = []
    for m in range(M):
        seed = int(np.random.SeedSequence([base, pp.rank, m]).generate_state(1, np.uint64)[0])
        out.append(torch.Generator(device=device).manual_seed(seed >> 1))
    return out


def _forward_stage(model, cfg, pp: PPContext, xb: torch.Tensor, *, train: bool,
                   generator, h_in: torch.Tensor | None):
    """One microbatch through this stage: (stream in, stream or logits out)."""
    from genomics_lm_torch.models import codon_gpt

    if pp.is_first:
        h_in = codon_gpt.embed_stream(model, cfg, xb, train=train, generator=generator)
    h, _ = codon_gpt.run_blocks(model, cfg, xb, h_in, train=train, generator=generator)
    if pp.is_last:
        h = codon_gpt._lm_logits(model, cfg, codon_gpt.final_stream(model, cfg, xb, h))
    return h_in, h


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        with timed(t.device, t.numel() * t.element_size()):
            dist.all_reduce(t, group=group)
    return t


def make_pipeline_group_step(cfg, pp: PPContext, dp=None):
    """The trainer's group step (``train_step.make_train_step``'s contract)
    under the pipeline::

        metrics = step(model, optimizer, batch, generator, lr_scale)

    ``batch["x"]``/``["y"]`` are (G, B, T): this rank's rows of the group,
    consumed as ONE GPipe run of G microbatches that commits the exact
    token-weighted whole-group CE (JAX's ``make_pipeline_group_step``,
    ``:363-437``). The nonfinite check is per group: a nonfinite loss or
    gradient on any rank skips the whole update. ``first_loss`` is the
    group loss and ``discarded_before_nonfinite`` is 0. Only the plain
    next-token CE: the trainer refuses every other objective first."""
    from genomics_lm_torch.training.train_step import _trainable

    def step(model, optimizer, batch: dict, generator, lr_scale: float = 1.0) -> dict:
        x, y = batch["x"], batch["y"]
        G = x.shape[0]
        device = x.device
        params, n_partial = _trainable(model)
        for p in params:
            p.grad = None
        counts = torch.stack([(y != PAD_ID).sum().float(), _denominator(cfg, y)])
        if dp is not None:
            dp.all_reduce(counts)
        nonpad, denom = counts[0], counts[1].clamp_min(1e-12)
        gens = _microbatch_generators(generator if cfg.dropout > 0.0 else None, pp, G, device)
        weight = _ce_weight(cfg, device)
        numer = torch.zeros((), dtype=torch.float32, device=device)
        saved = []
        for m in range(G):
            h_in = None
            if not pp.is_first:
                h_in = _recv(_stream_shape(model, cfg, x[m]), cfg.dtype, device, pp.prev,
                             pp).requires_grad_()
            h_in, out = _forward_stage(model, cfg, pp, x[m], train=True, generator=gens[m],
                                       h_in=h_in)
            if pp.is_last:
                n_m, _ = cross_entropy_parts(out, y[m], ignore_index=PAD_ID,
                                             label_smoothing=cfg.label_smoothing,
                                             weight=weight)
                numer = numer + n_m.detach()
                out = n_m / denom
            else:
                _send(out, pp.next, pp)
            saved.append((h_in, out))
        for m in reversed(range(G)):
            h_in, out = saved.pop()
            if pp.is_last:
                torch.autograd.backward(out)
            else:
                torch.autograd.backward(out, _recv(out.shape, out.dtype, device, pp.next, pp))
            if not pp.is_first:
                _send(h_in.grad, pp.prev, pp)
        sizes = [p.numel() for p in params]
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                           .reshape(-1).float() for p in params])
        for p in params:
            p.grad = None
        tp = getattr(model, "tp", None)
        if n_partial and tp is not None:
            _reduce(grads[: sum(sizes[:n_partial])], tp.group)
        names = {id(p): n for n, p in model.named_parameters()}
        off = 0
        for p, size in zip(params, sizes):  # the replicated parameters: summed over stages
            if not names[id(p)].startswith("blocks."):
                _reduce(grads[off: off + size], pp.group)
            off += size
        if dp is not None:
            dp.all_reduce(grads)
        # the group loss over the stages and the data axis, and any rank's
        # nonfinite gradient
        vec = torch.stack([numer, (~torch.isfinite(grads).all()).float()])
        _reduce(vec, pp.group)
        if dp is not None:
            dp.all_reduce(vec)
        if tp is not None:
            _reduce(vec[1:], tp.group)
        loss = vec[0] / denom
        group_ok = torch.isfinite(loss) & (vec[1] == 0)
        if bool(group_ok):  # the group's one host read
            for p, g in zip(params, torch.split(grads, sizes)):
                p.grad = g.view_as(p)
            optimizer.step(lr_scale)
        ok_f, ok_i = group_ok.float(), group_ok.int()
        committed = ok_i * G
        return {
            "applied": group_ok,
            "saw_nonfinite": ~group_ok,
            "finite_microbatches": committed,
            "committed_microbatches": committed,
            "discarded_before_nonfinite": torch.zeros((), dtype=torch.int32, device=device),
            "first_loss": loss,
            "total_loss_sum": loss * G * ok_f,
            "next_loss_sum": loss * G * ok_f,
            "nonpad_tokens": nonpad.int() * ok_i,
        }

    return step


def _denominator(cfg, y: torch.Tensor) -> torch.Tensor:
    """The class-weighted count of the non-pad targets of ``y``: the
    denominator of ``cross_entropy_parts``."""
    from genomics_lm_torch.parallel.data_parallel import loss_denominators
    from genomics_lm_torch.training.train_step import LossConfig

    return loss_denominators(cfg, LossConfig(), y.reshape(-1, y.shape[-1]))[0]


def make_pipeline_eval_step(cfg, pp: PPContext, dp=None, max_microbatch_rows: int = 8):
    """Validation step (``train_step.make_eval_step``'s contract) under the
    pipeline, JAX's ``make_pipeline_eval_step`` (``:440-477``): this rank's
    rows are padded with PAD rows up to the pipeline quantum, microbatches
    of at most ``max_microbatch_rows`` rows and at least S of them, which is
    exact (a PAD row adds nothing to the CE's numerator or denominator).
    Returns the token-weighted batch CE as both losses and
    ``next_loss_token_sum`` = loss x non-pad tokens, over the data axis."""

    @torch.no_grad()
    def step(model, xb: torch.Tensor, yb: torch.Tensor) -> dict:
        rows = xb.shape[0]
        mb = max(1, min(max_microbatch_rows, rows // pp.size))
        M = max(pp.size, -(-rows // mb))
        pad = M * mb - rows
        if pad:
            xb = torch.cat([xb, xb.new_zeros(pad, xb.shape[1])])
            yb = torch.cat([yb, yb.new_zeros(pad, yb.shape[1])])
        device = xb.device
        weight = _ce_weight(cfg, device)
        parts = torch.zeros(3, dtype=torch.float32, device=device)
        for m in range(M):
            x_m, y_m = xb[m * mb:(m + 1) * mb], yb[m * mb:(m + 1) * mb]
            h_in = None
            if not pp.is_first:
                h_in = _recv(_stream_shape(model, cfg, x_m), cfg.dtype, device, pp.prev, pp)
            _, out = _forward_stage(model, cfg, pp, x_m, train=False, generator=None,
                                    h_in=h_in)
            if pp.is_last:
                n_m, d_m = cross_entropy_parts(out, y_m, ignore_index=PAD_ID,
                                               label_smoothing=cfg.label_smoothing,
                                               weight=weight)
                parts += torch.stack([n_m, d_m, (y_m != PAD_ID).sum().float()])
            else:
                _send(out, pp.next, pp)
        _reduce(parts, pp.group)
        if dp is not None:
            dp.all_reduce(parts)
        loss = parts[0] / parts[1].clamp_min(1e-12)
        return {"total_loss": loss, "next_loss": loss, "nonpad_tokens": parts[2].int(),
                "next_loss_token_sum": loss * parts[2]}

    return step


__all__ = [
    "PIPE_AXIS",
    "PPContext",
    "make_pipeline_eval_step",
    "make_pipeline_group_step",
    "merge_stage_params",
    "split_stage_params",
    "stage_layers",
    "stage_model",
    "stage_to_full",
]
