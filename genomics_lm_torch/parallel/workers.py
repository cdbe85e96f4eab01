"""Rank-side workers of the parallel paths, for ``launch.spawn``.

Each function runs on one rank of a launched world and drives a main path
the way a user's rank would, returning what the caller compares with the
one-process run: ``group_steps`` (the trainer's group step under a data /
model / pipe mesh), ``train_cli`` (the train CLI's launch path, optionally
with a SIGTERM sent to one rank) and ``serve`` (a ``ServingEngine`` drain
under a model mesh); ``each`` runs several of them in one launch, and
``wait_for`` holds a launch started early until its caller signals. ``chip_smoke.py``
runs them on the card and the tests on the CPU; they import torch and the
port only.
"""

from __future__ import annotations

import contextlib
import copy
import os
import signal
import time

import numpy as np
import torch

from genomics_lm_torch.parallel import launch
from genomics_lm_torch.parallel import mesh as mesh_lib
from genomics_lm_torch.parallel import tensor_parallel as tpl
from genomics_lm_torch.parallel.data_parallel import DPContext


def strided_rows(x: np.ndarray, rank: int, n: int) -> np.ndarray:
    """Rank ``rank`` of ``n``'s rows of each (B, T) microbatch of a
    (G, B, T) group: rows ``rank::n`` (``EpochPlan.microbatches``' host
    split), padded with all-PAD rows to ceil(B / n)."""
    local = x[:, rank::n]
    want = -(-x.shape[1] // n)
    if local.shape[1] < want:
        pad = np.zeros((x.shape[0], want - local.shape[1], x.shape[2]), x.dtype)
        local = np.concatenate([local, pad], axis=1)
    return local


def _flash_launches() -> dict:
    from genomics_lm_torch.ops import flash_attention as fa

    return {w.__name__: w.launches for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)}


def group_steps(rank: int, world: int, spec: dict) -> dict:
    """Group steps of the trainer under ``spec["axes"]`` (a mesh over the
    world), from the full weights ``spec["tree"]`` (the JAX layout): each
    rank takes its strided rows of every (G, B, T) group in
    ``spec["groups"]`` ([(x, y)]), ``spec["warmup"]`` groups run untimed
    before them. A ``pipe`` axis runs the pipeline's group step on this
    rank's stage (``parallel/pipeline.py``); on a MoE config a ``model``
    axis is expert parallel. Returns each group's metrics, the seconds,
    collective seconds, calls and bytes by operation, and flash launches of
    the timed groups, the optimizer's state bytes and the expert weights'
    bytes on this rank and, on rank 0, the updated weights (JAX layout; not
    with ``spec["return_tree"]`` False) and, with ``spec["return_grads"]``,
    the group's gradient (port layout, every stage's) and, with
    ``spec["return_optimizer"]``, the optimizer state in the checkpoint's
    one-process layout. ``spec["eval"]``
    ([(x, y)] global batches) runs the trainer's eval step on each after the
    groups, this rank's strided rows padded to equal shares, and returns
    its outputs. With ``spec["axes"]`` None the step runs with no mesh, as
    the one-process trainer's; ``spec["deterministic"]`` turns on torch's
    deterministic algorithms (the embedding gradient's accumulation order).
    A list of specs runs each in turn."""
    if isinstance(spec, list):
        return [group_steps(rank, world, s) for s in spec]
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.parallel import pipeline as pp_lib
    from genomics_lm_torch.training.loop import (
        EVAL_METRIC_KEYS,
        GROUP_METRIC_KEYS,
        gather_full_state,
        read_metrics,
    )
    from genomics_lm_torch.training.optim import build_optimizer
    from genomics_lm_torch.training.train_step import LossConfig, make_eval_step, make_train_step
    from genomics_lm_torch.utils.weights import params_from_jax

    t_start = time.perf_counter()
    if spec.get("deterministic"):  # bit-for-bit comparisons: no atomics' ordering
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    device = mesh_lib.rank_device(spec.get("device"))
    # axes None: no mesh at all, the one-process trainer's step
    mesh = mesh_lib.make_mesh(axes=spec["axes"]) if spec["axes"] is not None else None
    cfg = CodonGPTConfig(**spec["model"])  # residual_sharding: sequence parallelism
    model = params_from_jax(spec["tree"], cfg, device).train()
    template = (copy.deepcopy(model).cpu()
                if rank == 0 and mesh is not None and spec.get("return_tree", True) else None)
    pipe = mesh is not None and mesh.axis_size(mesh_lib.PIPE_AXIS) > 1
    if pipe:
        pp_lib.stage_model(model, pp_lib.PPContext.from_mesh(mesh, cfg.n_layer))
    if mesh is not None and mesh.axis_size(mesh_lib.MODEL_AXIS) > 1:
        tpl.shard_model(model, tpl.TPContext.from_mesh(mesh))
    n_dp = mesh.axis_size(mesh_lib.DATA_AXIS) if mesh is not None else 1
    dp_rank = mesh.axis_rank(mesh_lib.DATA_AXIS) if mesh is not None else 0
    dp = DPContext.from_mesh(mesh)
    bundle = build_optimizer(spec["run_cfg"], model, spec.get("total_steps", 100), dp=dp)
    loss_cfg = LossConfig(**spec.get("loss", {}))
    if pipe:
        step = pp_lib.make_pipeline_group_step(cfg, model.pp, dp=dp)
        eval_step = pp_lib.make_pipeline_eval_step(cfg, model.pp, dp=dp)
    else:
        step = make_train_step(cfg, loss_cfg, dp=dp)
        eval_step = make_eval_step(cfg, loss_cfg, dp=dp)
    gen = None
    if cfg.dropout > 0:
        gen = torch.Generator(device=device).manual_seed(spec.get("seed", 0) + dp_rank)

    def batch(x, y):
        return {k: torch.from_numpy(strided_rows(a, dp_rank, n_dp)).long().to(device)
                for k, a in (("x", x), ("y", y))}

    # the global microbatch's rows: a rank's padding rows are not in it
    groups = [dict(batch(x, y), rows=x.shape[1]) for x, y in spec["groups"]]
    setup_seconds = time.perf_counter() - t_start
    for i in range(spec.get("warmup", 0)):
        step(model, bundle, groups[i % len(groups)], gen, 1.0)
    for w in _launch_counters():
        w.launches = 0
    launch.reset_collective_timing(spec.get("time_collectives", False))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with recorded_routes(dropped_choices) as dropped:
        metrics = [step(model, bundle, g, gen, 1.0) for g in groups]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    collective = dict(launch.COLLECTIVES)
    launch.reset_collective_timing(False)
    launches = _flash_launches() if cfg.attention_impl == "flash" else {}
    keys = GROUP_METRIC_KEYS
    out = {"metrics": [read_metrics(m, keys) for m in metrics], "seconds": seconds,
           "collective_seconds": collective["seconds"], "collectives": collective["calls"],
           "collective_bytes": collective["bytes_by_op"],
           "collective_counts": collective["count_by_op"],
           "collective_seconds_by_op": collective["seconds_by_op"],
           "dropped_choices": int(sum(int(c) for c in dropped)),
           "launches": launches, "state_bytes": bundle.state_bytes(),
           **_resident_bytes(model, bundle, cfg),
           "local_tokens": int(sum(int((g["y"] != 0).sum()) for g in groups)),
           "setup_seconds": setup_seconds}
    if spec.get("eval"):
        out["eval"] = []
        for x, y in spec["eval"]:
            b = batch(x[None], y[None])
            out["eval"].append(read_metrics(eval_step(model, b["x"][0], b["y"][0]),
                                            EVAL_METRIC_KEYS))
    t0 = time.perf_counter()
    if spec.get("return_tree", True):
        out["tree"], opt = gather_full_state(model, bundle, cfg, template, mesh)
        if spec.get("return_optimizer"):
            from genomics_lm_torch.training.checkpoints import _host_tree

            out["optimizer"] = _host_tree(opt)
    if spec.get("return_grads"):
        out["grads"] = _gather_grads(model, dp_rank)
    out["gather_seconds"] = time.perf_counter() - t0
    return out


@contextlib.contextmanager
def recorded_routes(take):
    """``take(kwargs, route)`` of every ``moe_route`` call while the block
    runs (its keyword arguments and result), in call order; a None is not
    kept."""
    from genomics_lm_torch.models import codon_gpt

    kept, route = [], codon_gpt.moe_route

    def record(*args, **kwargs):
        out = route(*args, **kwargs)
        item = take(kwargs, out)
        if item is not None:
            kept.append(item)
        return out

    codon_gpt.moe_route = record
    try:
        yield kept
    finally:
        codon_gpt.moe_route = route


def dropped_choices(kwargs: dict, route: dict):
    """For ``recorded_routes``: the choices a capped routing drops (of the
    rows in the global microbatch), a 0-dim tensor read after the groups."""
    if not kwargs.get("capped"):
        return None
    valid = route.get("valid")
    return (~route["keep"] if valid is None else ~route["keep"] & valid[:, None]).sum()


def _resident_bytes(model, bundle, cfg) -> dict:
    """The bytes this rank holds: all parameters and, of a MoE model, the
    expert banks' (``.mlp.``), and the optimizer moments of each."""
    def expert(name):
        return bool(cfg.moe_experts) and ".mlp." in name

    names = {id(p): n for n, p in model.named_parameters()}
    moments = [(names.get(id(p), ""), t) for p, st in bundle.optimizer.state.items()
               if not isinstance(p, str) for t in st.values()
               if isinstance(t, torch.Tensor) and t.dim() > 0]
    return {"param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "expert_bytes": sum(p.numel() * p.element_size()
                                for n, p in model.named_parameters() if expert(n)),
            "expert_state_bytes": sum(t.numel() * t.element_size()
                                      for n, t in moments if expert(n))}


def _gather_grads(model, dp_rank: int) -> dict | None:
    """Every parameter's ``.grad`` in the full layout (every stage's), on
    rank 0."""
    from genomics_lm_torch.parallel import pipeline as pp_lib
    from genomics_lm_torch.training.checkpoints import gather_to_writer

    tp, pp = getattr(model, "tp", None), getattr(model, "pp", None)
    piece = ({"tp": tp.rank if tp is not None else 0, "stage": pp.rank if pp is not None else 0,
              "grads": {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                        if p.grad is not None}} if dp_rank == 0 else None)
    pieces = gather_to_writer(piece)
    if pieces is None:
        return None
    return pp_lib.assemble_pieces(pieces, "grads", tp.layout if tp is not None else {}, pp)


def _launch_counters():
    from genomics_lm_torch.ops import decode_attention as da
    from genomics_lm_torch.ops import flash_attention as fa

    return (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, da.decode_attention,
            da.decode_attention_chunk)


def train_cli(rank: int, world: int, argv: list, sigterm_rank: int | None = None) -> dict:
    """The train CLI (``training/train_codon_lm.py``) on this rank, as a
    launcher would start it; with ``sigterm_rank`` that rank sends itself
    SIGTERM after its first group. Returns the CLI's exit code."""
    from genomics_lm_torch.training import loop
    from genomics_lm_torch.training.train_codon_lm import main

    if sigterm_rank == rank:
        read = loop.read_metrics
        sent = []

        def read_then_signal(metrics, keys):
            out = read(metrics, keys)
            if "applied" in keys and not sent:  # a group's metrics, not validation's
                sent.append(True)
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        loop.read_metrics = read_then_signal
    return {"rc": main(argv)}


def train_cli_sigterm(rank: int, world: int, argv: list) -> dict:
    """``train_cli`` with rank 0 sending itself SIGTERM after its first group."""
    return train_cli(rank, world, argv, sigterm_rank=0)


def serve(rank: int, world: int, spec: dict) -> dict:
    """A ``ServingEngine`` drain under a ``model`` mesh of the world (or
    none with ``spec["mesh"]`` False) from the full weights
    ``spec["tree"]``: ``spec["requests"]`` ([(prompt, max_new,
    temperature)]) through ``spec["engine"]``'s options. Returns each
    request's tokens, the engine's stats, the seconds of the drain and the
    decode and chunk kernels' launches and the shapes of its state tensors
    on this rank. A list of specs runs each in turn."""
    if isinstance(spec, list):
        return [serve(rank, world, s) for s in spec]
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.ops import decode_attention as da
    from genomics_lm_torch.ops.quant import quantize_params
    from genomics_lm_torch.serving.engine import ServingEngine
    from genomics_lm_torch.utils.weights import params_from_jax

    device = mesh_lib.rank_device(spec.get("device"))
    cfg = CodonGPTConfig(**spec["model"])
    model = params_from_jax(spec["tree"], cfg, device)
    if spec.get("int8_weights"):
        quantize_params(model)
    mesh = mesh_lib.make_mesh(axes={mesh_lib.MODEL_AXIS: world}) if spec.get("mesh", True) else None
    engine = ServingEngine(model, cfg, mesh=mesh, device=device, **spec["engine"])
    for prompt, max_new, temperature in spec["requests"]:
        engine.submit(list(prompt), int(max_new), temperature=float(temperature))
    da.decode_attention.launches = 0
    da.decode_attention_chunk.launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    results = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"tokens": {rid: list(r.tokens) for rid, r in results.items()},
            "stats": engine.stats(), "seconds": time.perf_counter() - t0,
            "state_shapes": {n: tuple(t.shape) for n, t in engine.state.items()
                             if isinstance(t, torch.Tensor)},
            "launches": {"decode_attention": da.decode_attention.launches,
                         "decode_attention_chunk": da.decode_attention_chunk.launches}}


def wait_for(rank: int, world: int, signal_dir: str, timeout_s: float = 1200.0) -> None:
    """Wait, started and joined, until ``signal_dir`` holds a file ``go``
    (return) or ``stop`` (raise): a launch started early, whose ranks reach
    the card while the caller still works, begins its calls on the signal."""
    from pathlib import Path

    signal_dir, end = Path(signal_dir), time.monotonic() + timeout_s
    while not (signal_dir / "go").exists():
        if (signal_dir / "stop").exists() or time.monotonic() > end:
            raise RuntimeError(f"rank {rank}: stopped before its calls ({signal_dir})")
        time.sleep(0.1)


def each(rank: int, world: int, calls: list) -> list:
    """Several workers in one launch (each process takes seconds to start
    and reach a card): ``calls`` is ``[(worker name, argument)]``, run in
    turn on this rank; their results in order."""
    return [globals()[name](rank, world, arg) for name, arg in calls]


__all__ = ["each", "group_steps", "serve", "strided_rows", "train_cli", "train_cli_sigterm",
           "wait_for"]
