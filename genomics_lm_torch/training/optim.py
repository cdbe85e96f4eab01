"""Optimizer and LR schedules (twin of ``genomics_lm_tpu/training/optim.py``).

The JAX package builds an optax ``multi_transform`` over a label tree; here
one optimizer holds one parameter group per label, the labels given by
the JAX rules applied to the parameter names (which carry the same
markers as the JAX paths):

- ``fast`` (``shape_proj``, ``offset_projs``, ``termination_head``):
  ``lr_embedding``, weight decay 0;
- ``base`` (every other parameter: biases, layer norms and embeddings
  included, exactly as JAX labels them): ``lr``, ``weight_decay``;
- ``lora`` (the adapters' ``lora_a``/``lora_b``): ``lora_lr`` (default
  ``lr``), weight decay 0;
- ``frozen``: ``lora_scale``; the shape encoder unless
  ``unfreeze_encoder``; everything outside ``fast`` under
  ``freeze_backbone``, and outside ``fast`` and ``lora`` under
  ``lora_only`` (default: on when ``lora_rank`` is set). A frozen
  parameter gets ``requires_grad=False``, so no weight-gradient product is
  computed for it (JAX puts it under ``stop_gradient``), and it is in no
  group: the optimizer holds no state for it.

``optimizer: adafactor`` is optax's ``adafactor(lr,
multiply_by_parameter_scale=False)`` in each group (no weight decay),
written here (``Adafactor``) on the JAX leaves (``utils/weights.py::
jax_leaves``): its statistics are factored over each stacked leaf's two
largest dimensions and its update clipped by each leaf's RMS, as optax
does, with the fused QKV split into its three leaves. ``grad_clip`` is
optax's ``clip_by_global_norm`` on the averaged gradient of the trainable
parameters, before the update.

Optax's ``adamw`` and torch's ``AdamW`` are the same update: decoupled
decay of the pre-update parameter, bias-corrected moments, and ``eps``
outside the square root. The cosine multiplier is evaluated per applied
optimizer step, as optax counts its updates, and ``lr_scale`` multiplies
each group's lr for that step, which is torch's counterpart of the JAX
step's ``updates * lr_scale`` (it scales the decay step too, as there).

``resolve_warmup_steps``, ``cosine_lr_lambda``, ``PlateauScheduler`` and
``resolve_epochs`` are plain-Python copies.

ZeRO-1 (``shard_optimizer_state`` under data parallelism, ``dp``): the
trainable parameters are dealt out to the data-parallel ranks
(``parallel/sharding.py::zero1_owners``; for Adafactor, whole JAX leaves,
with the leaves that share a parameter kept together), each rank's
optimizer holds and steps only its own, and ``ZeroSync`` then gathers
every rank's updated parameters in one all-gather. Every rank holds the
whole averaged gradient, so the update is the unsplit one; each rank holds
about 1/dp of the moments. Under tensor parallelism ``grad_clip``'s norm
counts each split parameter's slices once over the model axis, and under
pipeline parallelism each stage's blocks once over the stages.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

FAST_GROUP_MARKERS = ("shape_proj", "offset_projs", "termination_head")


def resolve_warmup_steps(cfg: dict, total_steps: int) -> int:
    """Fixed or scheduler-relative warmup without ambiguous precedence."""
    if total_steps <= 0:
        raise ValueError("scheduler_total_steps must be positive")
    fraction = cfg.get("warmup_fraction")
    if fraction is None:
        steps = int(cfg.get("warmup_steps", 200))
        if steps < 0:
            raise ValueError("warmup_steps must be non-negative")
        return steps
    if "warmup_steps" in cfg:
        raise ValueError("configure only one of warmup_steps or warmup_fraction")
    fraction = float(fraction)
    if not 0.0 <= fraction < 1.0:
        raise ValueError("warmup_fraction must be in [0, 1)")
    if fraction == 0.0:
        return 0
    return max(1, int(round(total_steps * fraction)))


def cosine_lr_lambda(warmup_steps: int, total_steps: int, min_lr_ratio: float) -> Callable:
    """The reference cosine-with-warmup multiplier, on a Python step index."""
    warmup = max(1, warmup_steps)

    def lr_lambda(step_idx: int) -> float:
        if step_idx < warmup:
            return (step_idx + 1.0) / warmup
        progress = (step_idx - warmup) / max(1, total_steps - warmup)
        cosine = 0.5 * (1.0 + math.cos(math.pi * progress))
        return min_lr_ratio + (1 - min_lr_ratio) * cosine

    return lr_lambda


@dataclass
class PlateauScheduler:
    """Host-side ReduceLROnPlateau (mode=min, factor 0.5) with warmup.

    ``scale()`` is passed to the step as its ``lr_scale``.
    """

    base_lr: float
    min_lr: float = 1e-5
    factor: float = 0.5
    patience: int = 2
    warmup_steps: int = 0
    best: float = field(default=float("inf"))
    num_bad_epochs: int = 0
    current_scale: float = 1.0

    def scale(self, step: int) -> float:
        s = self.current_scale
        if self.warmup_steps > 0 and step < self.warmup_steps:
            s *= float(step + 1) / max(1, self.warmup_steps)
        return s

    def step_metric(self, metric: float) -> None:
        if metric < self.best:
            self.best = metric
            self.num_bad_epochs = 0
            return
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            floor = self.min_lr / self.base_lr if self.base_lr > 0 else 0.0
            self.current_scale = max(self.current_scale * self.factor, floor)
            self.num_bad_epochs = 0

    def state_dict(self) -> dict[str, Any]:
        return {
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "current_scale": self.current_scale,
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.best = float(state.get("best", float("inf")))
        self.num_bad_epochs = int(state.get("num_bad_epochs", 0))
        self.current_scale = float(state.get("current_scale", 1.0))


def param_group_labels(
    model: torch.nn.Module,
    *,
    freeze_backbone: bool = False,
    unfreeze_encoder: bool = False,
    lora_only: bool = False,
) -> dict[str, str]:
    """Label each parameter 'fast' | 'base' | 'lora' | 'frozen' by its name,
    with the JAX rules for a leaf's path (the same markers appear in both)."""

    def label_path(path: str) -> str:
        if "lora_scale" in path:
            return "frozen"
        if "lora_" in path:
            return "lora"
        if "shape_encoder" in path:
            return "base" if (unfreeze_encoder and not freeze_backbone) else "frozen"
        fast = any(marker in path for marker in FAST_GROUP_MARKERS)
        if freeze_backbone or lora_only:
            return "fast" if fast else "frozen"
        return "fast" if fast else "base"

    return {name: label_path(name) for name, _ in model.named_parameters()}


def _factored_dims(shape: tuple[int, ...], min_dim_size_to_factor: int = 128):
    """optax's choice: the two largest axes, when the second is >= 128."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def leaf_tp_axis(leaf, layout: dict, names: dict) -> int | None:
    """The axis of ``leaf`` (in the JAX layout) that the model axis splits,
    or None: the ``Split`` of its parameter (``layout``, by ``names[id]``)
    mapped through the leaf's transpose and layer stack."""
    p, _, t = leaf.parts[0]
    split = layout.get(names[id(p)])
    if split is None:
        return None
    axis = p.dim() - 1 - split.dim if t else split.dim
    return axis + (1 if leaf.stacked else 0)


class Adafactor:
    """optax ``adafactor(learning_rate, multiply_by_parameter_scale=False)``
    over the JAX leaves of the parameters in ``param_groups``: per leaf,
    factored second moments (row and column means of g² + 1e-30 over its
    two largest axes, when the second is >= 128) or a full one, decayed at
    ``1 - (t + 1)^-0.8``; the update g / sqrt(v) divided by max(1, its RMS)
    and scaled by -lr. No momentum, no weight decay.

    Under pipeline parallelism (``pp``) a stage holds its layers of each
    stacked leaf: their statistics are per layer, and the RMS of a stacked
    leaf's update is the whole leaf's, its sum of squares summed over the
    stages (every stage holds as many layers).

    Under tensor parallelism (``tp``, with ``tp_axis[path]`` the JAX-layout
    axis the model axis splits, or None) a rank holds its slice of each
    split leaf and of its statistics, and the results are the whole leaf's:
    which axes are factored is read from the global shape (a leaf factored
    globally may be too small to factor on a rank); a row or column mean
    over the split axis, and the row statistics' mean over it, are sums
    over the model axis divided by the global size; the RMS clip sums the
    update's squares over the model axis (and, under PP x TP, over the
    stages too). The means of one step share one all-reduce, the squares
    another. ``stat_axes[path]`` gives each statistic's split axis, by which
    the checkpoint joins the ranks' slices at the JAX leaf's positions."""

    def __init__(self, param_groups: list[dict], leaves, pp=None, tp=None,
                 tp_axis: dict | None = None):
        self.param_groups = param_groups
        self.pp = pp
        self.tp = tp if tp is not None and tp.size > 1 else None
        group_of = {id(p): g for g in param_groups for p in g["params"]}
        self.leaves = [(leaf, group_of[id(leaf.parts[0][0])]) for leaf in leaves
                       if id(leaf.parts[0][0]) in group_of]
        self.count = 0
        self.state: dict[str, dict[str, torch.Tensor]] = {}
        self.axis: dict[str, int | None] = {}  # the leaf's split axis
        self.dims: dict[str, tuple[int, int] | None] = {}  # factored, from the global shape
        self.stat_axes: dict[str, dict[str, int | None]] = {}
        for leaf, _ in self.leaves:
            shape = tuple(leaf.gather().shape)
            axis = (tp_axis or {}).get(leaf.path) if self.tp is not None else None
            full = tuple(n * self.tp.size if d == axis else n for d, n in enumerate(shape))
            dims = _factored_dims(full)
            self.axis[leaf.path], self.dims[leaf.path] = axis, dims
            device = leaf.parts[0][0].device
            zeros = lambda s: torch.zeros(tuple(int(d) for d in s), device=device)  # noqa: E731
            if dims is None:
                self.state[leaf.path] = {"v": zeros(shape)}
                self.stat_axes[leaf.path] = {"v": axis}
            else:
                d1, d0 = dims
                self.state[leaf.path] = {"v_row": zeros(np.delete(shape, d0)),
                                         "v_col": zeros(np.delete(shape, d1))}
                self.stat_axes[leaf.path] = {
                    "v_row": _reduced_axis(axis, d0), "v_col": _reduced_axis(axis, d1)}

    @staticmethod
    def _all_reduce(parts: list[torch.Tensor], group) -> list[torch.Tensor]:
        """Every tensor of ``parts`` summed over ``group``, in one collective."""
        from genomics_lm_torch.parallel.launch import timed

        flat = torch.cat([t.reshape(-1) for t in parts])
        with timed(flat.device, 4 * flat.numel()):
            dist.all_reduce(flat, group=group)
        out, off = [], 0
        for t in parts:
            out.append(flat[off: off + t.numel()].view_as(t))
            off += t.numel()
        return out

    @torch.no_grad()
    def step(self) -> None:
        t = torch.tensor(self.count + 1, dtype=torch.float32)
        decay = float(1.0 - t ** -0.8)
        grads, sums = {}, []  # sums: (path, what, local partial sum) to reduce over tp
        for leaf, _ in self.leaves:
            g = leaf.gather(lambda p: p.grad).float()
            grads[leaf.path] = g
            st, axis, dims = self.state[leaf.path], self.axis[leaf.path], self.dims[leaf.path]
            grad_sqr = g * g + 1e-30
            if dims is None:
                st["v"] = decay * st["v"] + (1.0 - decay) * grad_sqr
                continue
            d1, d0 = dims
            if axis == d0:
                sums.append((leaf.path, "row", grad_sqr.sum(dim=d0)))
            else:
                st["v_row"] = decay * st["v_row"] + (1.0 - decay) * grad_sqr.mean(dim=d0)
            if axis == d1:
                sums.append((leaf.path, "col", grad_sqr.sum(dim=d1)))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                sums.append((leaf.path, "row_col",
                             st["v_row"].sum(dim=reduced_d1, keepdim=True)))
            else:
                st["v_col"] = decay * st["v_col"] + (1.0 - decay) * grad_sqr.mean(dim=d1)
        parts = self._all_reduce([v for _, _, v in sums], self.tp.group) if sums else []
        reduced = {(path, what): v for (path, what, _), v in zip(sums, parts)}
        updates = []
        for leaf, group in self.leaves:
            g, st = grads[leaf.path], self.state[leaf.path]
            axis, dims = self.axis[leaf.path], self.dims[leaf.path]
            if dims is None:
                update = g * st["v"] ** -0.5
            else:
                d1, d0 = dims
                size = lambda d: g.shape[d] * (self.tp.size if d == axis else 1)  # noqa: E731
                if (leaf.path, "row") in reduced:
                    row = reduced[(leaf.path, "row")] / size(d0)
                    st["v_row"] = decay * st["v_row"] + (1.0 - decay) * row
                if (leaf.path, "col") in reduced:
                    col = reduced[(leaf.path, "col")] / size(d1)
                    st["v_col"] = decay * st["v_col"] + (1.0 - decay) * col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                if (leaf.path, "row_col") in reduced:
                    row_col_mean = reduced[(leaf.path, "row_col")] / size(d1)
                else:
                    row_col_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
                row_factor = (st["v_row"] / row_col_mean) ** -0.5
                col_factor = st["v_col"] ** -0.5
                update = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            updates.append((leaf, group, update))
        # clip_by_block_rms(1.0) on the whole leaf: a leaf that ranks hold
        # parts of sums its squares over them
        split = [self.axis[leaf.path] is not None for leaf, _, _ in updates]
        stacked = [self.pp is not None and leaf.stacked for leaf, _, _ in updates]
        shared = [i for i in range(len(updates)) if split[i] or stacked[i]]
        mean_sq = [u.pow(2).mean() for _, _, u in updates]
        if shared:
            sq = torch.stack([updates[i][2].pow(2).sum() for i in shared])
            for group, mask in ((self.tp, split), (self.pp, stacked)):
                rows = [j for j, i in enumerate(shared) if mask[i]]
                if group is not None and rows:
                    idx = torch.tensor(rows, device=sq.device)
                    sq[idx] = self._all_reduce([sq[idx]], group.group)[0]
            for j, i in enumerate(shared):
                numel = updates[i][2].numel() * (self.tp.size if split[i] else 1) * (
                    self.pp.size if stacked[i] else 1)
                mean_sq[i] = sq[j] / numel
        for (leaf, group, update), q in zip(updates, mean_sq):
            self._apply(leaf, group, update, q)
        self.count += 1

    @staticmethod
    def _apply(leaf, group: dict, update: torch.Tensor, mean_sq: torch.Tensor) -> None:
        # clip_by_block_rms(1.0), then the step
        update = update / torch.clamp_min(mean_sq.sqrt(), 1.0)
        leaf.write(lambda p: p.data, update * -group["lr"], add=True)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "state": {path: dict(st) for path, st in self.state.items()}}

    def load_state_dict(self, saved: dict) -> None:
        unknown = sorted(set(saved["state"]) - set(self.state))
        missing = sorted(set(self.state) - set(saved["state"]))
        if unknown or missing:
            raise ValueError(f"Adafactor state: unknown leaves {unknown}, missing {missing}")
        for path, st in saved["state"].items():
            for key, value in st.items():
                if key not in self.state[path]:
                    raise ValueError(f"Adafactor state: {path} has no {key}")
                self.state[path][key] = torch.as_tensor(np.asarray(value)).to(
                    self.state[path][key].device)
        self.count = int(saved["count"])

    def local_state(self, full: dict, tp_rank: int) -> dict:
        """A checkpoint's whole-leaf statistics (``state`` keyed by path) cut
        to this rank's slices: each split statistic's chunk ``tp_rank`` of its
        split axis (a rank's part of a split leaf is one contiguous chunk of
        each JAX leaf, the fused QKV's query, key and value too)."""
        out = {}
        for path, st in full.items():
            axes = self.stat_axes.get(path, {})
            out[path] = {k: (np.array_split(np.asarray(v), self.tp.size, axis=ax)[tp_rank]
                             if self.tp is not None and (ax := axes.get(k)) is not None else v)
                         for k, v in st.items()}
        return out


def _reduced_axis(axis: int | None, removed: int) -> int | None:
    """Where the split ``axis`` lands in a statistic that averaged ``removed``
    away (None: not split, or averaged away: the statistic is whole)."""
    if axis is None or axis == removed:
        return None
    return axis - 1 if axis > removed else axis


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float, *, split=None, tp=None, block=None,
                        pp=None) -> None:
    """optax ``clip_by_global_norm``: scale every gradient by max_norm / norm
    when the global norm is at least max_norm (no epsilon), on the device.
    Under tensor parallelism (``tp``, with ``split[i]`` True for a parameter
    the model axis splits) the split parameters' squares are summed over
    the model axis; under pipeline parallelism (``pp``, with ``block[i]``
    True for a parameter of the stage's blocks) the blocks' squares are
    summed over the stages, the replicated parameters' counted once."""
    grads = [p.grad for p in params]
    if tp is None and pp is None:
        norm = torch.stack([g.float().pow(2).sum() for g in grads]).sum().sqrt()
    else:
        from genomics_lm_torch.parallel.launch import timed

        sq = torch.zeros(3, dtype=torch.float32, device=grads[0].device)
        for i, g in enumerate(grads):
            where = 0 if split and split[i] else (1 if block and block[i] else 2)
            sq[where] += g.float().pow(2).sum()
        for group, part in ((tp, sq[:1]), (pp, sq[:2])):
            if group is not None:
                with timed(sq.device, 4 * part.numel()):
                    dist.all_reduce(part, group=group.group)
        norm = sq.sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


class ZeroSync:
    """After a ZeRO-1 step, every rank's updated parameters on every rank:
    each rank packs the parameters it owns (in one fixed order) into one
    flat buffer, one all-gather over the data axis carries the buffers, and
    each rank unpacks the others'."""

    def __init__(self, params: list, owner: list[int], dp):
        self.dp = dp
        self.by_rank = [[p for p, o in zip(params, owner) if o == r] for r in range(dp.size)]
        self.numel = [sum(p.numel() for p in ps) for ps in self.by_rank]

    @torch.no_grad()
    def sync(self) -> None:
        mine = self.by_rank[self.dp.rank]
        width = max(self.numel)
        ref = mine[0] if mine else next(p for ps in self.by_rank for p in ps)
        buf = torch.zeros(width, dtype=torch.float32, device=ref.device)
        if mine:
            torch.cat([p.detach().reshape(-1).float() for p in mine], out=buf[: self.numel[self.dp.rank]])
        parts = [torch.empty_like(buf) for _ in range(self.dp.size)]
        from genomics_lm_torch.parallel.launch import timed

        with timed(buf.device, self.dp.size * buf.numel() * 4, "all-gather"):
            dist.all_gather(parts, buf, group=self.dp.group)
        for r, ps in enumerate(self.by_rank):
            if r == self.dp.rank:
                continue
            off = 0
            for p in ps:
                p.copy_(parts[r][off: off + p.numel()].view_as(p))
                off += p.numel()


@dataclass
class OptimizerBundle:
    """The optimizer (AdamW or ``Adafactor``) with one group per trainable
    label, and the schedule that drives its lr."""

    optimizer: Any
    labels: dict[str, str]
    schedule_name: str  # "cosine" | "plateau"
    total_steps: int
    warmup_steps: int
    plateau: PlateauScheduler | None
    lr_lambda: Callable[[int], float] | None
    grad_clip: float | None = None
    applied_steps: int = 0  # optimizer steps taken: the schedule's index
    params: list = field(default_factory=list)  # every trainable parameter
    split: list = field(default_factory=list)  # per parameter: split over the model axis
    block: list = field(default_factory=list)  # per parameter: of the blocks
    tp: Any = None
    pp: Any = None  # the pipe axis: the blocks' squares of the clip norm span the stages
    zero: ZeroSync | None = None

    def step(self, lr_scale: float = 1.0) -> None:
        """One step on the gradients in ``.grad`` (clipped first when
        ``grad_clip`` is set), at the group lrs of this step: base lr x
        schedule multiplier x ``lr_scale``."""
        mult = self.lr_lambda(self.applied_steps) if self.lr_lambda is not None else 1.0
        for group in self.optimizer.param_groups:
            group["lr"] = group["base_lr"] * mult * float(lr_scale)
        if self.grad_clip:
            clip_by_global_norm(self.trainable(), self.grad_clip, split=self.split,
                                tp=self.tp, block=self.block, pp=self.pp)
        self.optimizer.step()
        if self.zero is not None:
            self.zero.sync()
        self.applied_steps += 1

    def trainable(self) -> list[torch.nn.Parameter]:
        """Every trainable parameter (under ZeRO-1 also those another rank
        updates)."""
        return self.params

    def state_bytes(self) -> int:
        """Bytes of the optimizer's state tensors (the moments; AdamW's
        appear after its first step)."""
        return int(sum(t.numel() * t.element_size()
                       for st in self.optimizer.state.values() for t in st.values()
                       if isinstance(t, torch.Tensor)))


def model_leaves(model) -> list:
    """The JAX leaves ``model`` holds (``utils/weights.py::jax_leaves``); a
    tensor-parallel rank's, read through its heads' config, so that a fused
    QKV's query, key and value rows are this rank's."""
    from genomics_lm_torch.parallel.tensor_parallel import tp_local_config
    from genomics_lm_torch.utils.weights import jax_leaves

    tp = getattr(model, "tp", None)
    return jax_leaves(model, model.cfg if tp is None else tp_local_config(model.cfg, tp.size))


def _zero1_units(model, groups: list[dict], adafactor: bool):
    """ZeRO-1's units: (name, element count, its parameters). For AdamW a
    unit is one parameter; for Adafactor the JAX leaves that share
    parameters, joined (a fused QKV holds three leaves)."""
    names = {id(p): n for n, p in model.named_parameters()}
    trainable = [p for g in groups for p in g["params"]]
    if not adafactor:
        return [(names[id(p)], p.numel(), [p]) for p in trainable]
    keep = {id(p) for p in trainable}
    parent: dict[int, int] = {}

    def find(i):
        while parent.setdefault(i, i) != i:
            i = parent[i]
        return i

    leaves = [leaf for leaf in model_leaves(model) if id(leaf.parts[0][0]) in keep]
    for leaf in leaves:
        ids = [id(p) for p, _, _ in leaf.parts]
        for i in ids[1:]:
            parent[find(i)] = find(ids[0])
    units: dict[int, tuple[str, list]] = {}
    for leaf in leaves:
        for p, _, _ in leaf.parts:
            root = find(id(p))
            name, ps = units.setdefault(root, (leaf.path, []))
            if all(q is not p for q in ps):
                ps.append(p)
    return [(name, sum(p.numel() for p in ps), ps) for name, ps in units.values()]


def build_optimizer(cfg: dict, model: torch.nn.Module, total_steps: int, *,
                    dp=None) -> OptimizerBundle:
    """The optimizer and its schedule from a flat run config. Sets
    ``requires_grad=False`` on every parameter labeled frozen. With ``dp``
    (more than one data-parallel rank) and ``shard_optimizer_state`` the
    state is split ZeRO-1 style; a tensor-parallel ``model`` (``model.tp``)
    clips over the model axis."""
    base_lr = float(cfg.get("lr", 5e-6))
    lr_embed = float(cfg.get("lr_embedding", base_lr))
    lora_lr = float(cfg.get("lora_lr", base_lr))
    weight_decay = float(cfg.get("weight_decay", 0.05))
    min_lr = float(cfg.get("min_lr", 1e-5))
    optimizer_name = str(cfg.get("optimizer", "adamw")).lower()
    scheduler_name = str(cfg.get("scheduler", "cosine")).lower()
    if scheduler_name not in {"cosine", "plateau"}:
        scheduler_name = "cosine"
    warmup_steps = resolve_warmup_steps(cfg, total_steps)

    if scheduler_name == "cosine":
        min_lr_ratio = (min_lr / base_lr) if base_lr > 0 else 0.0
        lr_lambda = cosine_lr_lambda(warmup_steps, total_steps, min_lr_ratio)
        plateau = None
    else:
        # plateau: the caller passes plateau.scale(step) as lr_scale
        lr_lambda = None
        plateau = PlateauScheduler(base_lr=base_lr, min_lr=min_lr,
                                   patience=int(cfg.get("plateau_patience", 2)),
                                   warmup_steps=warmup_steps)

    labels = param_group_labels(
        model,
        freeze_backbone=bool(cfg.get("freeze_backbone", False)),
        unfreeze_encoder=bool(cfg.get("unfreeze_encoder", False)),
        lora_only=bool(cfg.get("lora_only", bool(cfg.get("lora_rank")))),
    )
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    settings = {"fast": (lr_embed, 0.0), "base": (base_lr, weight_decay),
                "lora": (lora_lr, 0.0)}
    groups = []
    for label, (lr, wd) in settings.items():
        params = [p for name, p in model.named_parameters() if labels[name] == label]
        if params:
            groups.append({"params": params, "lr": lr, "base_lr": lr,
                           "weight_decay": wd, "label": label})
    tp = getattr(model, "tp", None)
    pp = getattr(model, "pp", None)
    all_params = [p for g in groups for p in g["params"]]
    zero = None
    if dp is not None and bool(cfg.get("shard_optimizer_state", False)):
        from genomics_lm_torch.parallel.sharding import zero1_owners

        units = _zero1_units(model, groups, optimizer_name == "adafactor")
        owner = zero1_owners([(name, n) for name, n, _ in units], dp.size)
        owner_of = {id(p): owner[name] for name, _, ps in units for p in ps}
        zero = ZeroSync(all_params, [owner_of[id(p)] for p in all_params], dp)
        groups = [dict(g, params=[p for p in g["params"] if owner_of[id(p)] == dp.rank])
                  for g in groups]
    if optimizer_name == "adafactor":
        leaves = model_leaves(model)
        names = {id(p): n for n, p in model.named_parameters()}
        tp_axis = ({leaf.path: leaf_tp_axis(leaf, tp.layout, names) for leaf in leaves}
                   if tp is not None else None)
        optimizer = Adafactor(groups, leaves, pp=pp, tp=tp, tp_axis=tp_axis)
    else:
        optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
    grad_clip = cfg.get("grad_clip")
    split_names = {n for n, s in (tp.layout.items() if tp is not None else ()) if s}
    names = {id(p): n for n, p in model.named_parameters()}
    return OptimizerBundle(optimizer=optimizer, labels=labels,
                           schedule_name=scheduler_name, total_steps=total_steps,
                           warmup_steps=warmup_steps, plateau=plateau,
                           lr_lambda=lr_lambda,
                           grad_clip=float(grad_clip) if grad_clip else None,
                           params=all_params,
                           split=[names[id(p)] in split_names for p in all_params],
                           block=[names[id(p)].startswith("blocks.") for p in all_params],
                           tp=tp, pp=pp, zero=zero)


def resolve_epochs(cfg: dict, n_params: int, tokens_per_epoch: float) -> int:
    """``epochs: auto`` via the tokens-per-param heuristic (loop.py:745-759)."""
    epochs_cfg = cfg.get("epochs", 5)
    if isinstance(epochs_cfg, str) and epochs_cfg.strip().lower() == "auto":
        tokens_per_param = float(cfg.get("tokens_per_param", 20.0))
        tokens_target = max(1.0, tokens_per_param * float(n_params))
        per_epoch = max(1.0, float(tokens_per_epoch))
        est = int(math.ceil(tokens_target / per_epoch))
        est = max(
            int(cfg.get("epochs_min", 1)),
            min(est, int(cfg.get("epochs_max", max(1, est)))),
        )
        return est
    return int(epochs_cfg)


__all__ = [
    "Adafactor",
    "ZeroSync",
    "FAST_GROUP_MARKERS",
    "OptimizerBundle",
    "PlateauScheduler",
    "build_optimizer",
    "clip_by_global_norm",
    "leaf_tp_axis",
    "model_leaves",
    "cosine_lr_lambda",
    "param_group_labels",
    "resolve_epochs",
    "resolve_warmup_steps",
]
