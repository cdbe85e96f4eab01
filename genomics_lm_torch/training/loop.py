"""The codon-LM trainer (twin of ``genomics_lm_tpu/training/loop.py``).

``run_training`` follows the JAX trainer step for step, on one device or,
given a ``mesh`` (``parallel/mesh.py``), on one rank of several processes:

- primary-contract validation (``training/contracts.py``, fail closed;
  the OOM safeguard never rewrites a contract-bound config),
- manifest discovery and vocabulary-contract binding (fail closed),
- the run lifecycle: locking, serial directories, the configuration
  fingerprint, the newest-checkpoint and curve-history checks, epoch
  headroom,
- shape guidance (the nucleotide encoder, from ``shape_encoder_checkpoint``
  or fresh, and the codon one-hot table), transfer init through
  ``transfer_load_params`` with the vocabulary-row remap (the source may be
  a JAX checkpoint), LoRA adapters attached after it, and full resume:
  model (adapters included), optimizer state, the trainer's generator,
  step, group-aligned position and the accumulation-health counters,
- AdamW or Adafactor in the fast/base/lora groups with the frozen labels
  and ``grad_clip`` (``optim.build_optimizer``) over ``resolve_epochs``'
  total steps (cosine or plateau),
- the multi-offset, termination and replay losses (one replay batch a
  group, used on every ``replay_every_microbatches``-th microbatch), and
  remat (``use_checkpoint``),
- the epoch loop over ``grouped_batches`` and ``DevicePrefetcher``, one
  group step (``train_step.make_train_step``) per optimizer step, the
  nonfinite-group abort and its limit, periodic / wall-time / preemption
  saves,
- validation, ``curves.csv``, ``metrics.json``, ``meta.json``,
  ``last``/``best``/``best_epoch_NNN``/``epoch_N`` checkpoints, early
  stopping, and the OOM safeguard.

Checkpoints hold the model in the JAX tree layout (``params_to_jax``), so
the JAX package loads them, and the optimizer state of the trainable
parameters only: AdamW's keyed by parameter name (``optimizer.format`` =
``OPTIMIZER_FORMAT``), Adafactor's by JAX leaf (``ADAFACTOR_FORMAT``). A
checkpoint whose optimizer state is another trainer's (a JAX one holds
optax's) cannot resume here and says so; its weights still transfer with
``transfer_from``.

The host reads a group's metrics in one device→host copy (beside the
step's own read of whether the group commits), and validation in one copy
at its end: the path is host-bound.

The mesh branch (JAX's ``:372-380,405-545,617-642,931-958``): ranks on the
``data`` axis each take their strided rows of every global microbatch and
validation batch, padded with PAD rows to equal shares
(``EpochPlan.microbatches``), and the step reduces the loss sums, counts
and gradients over the axis (``train_step.py``); ``shard_optimizer_state``
splits the optimizer state ZeRO-1 style (``optim.py``). A ``model`` axis
splits every block Megatron style (``parallel/tensor_parallel.py``), and
``residual_sharding: [data, model]`` adds sequence parallelism. Rank 0
alone owns the run directory and writes every file; a checkpoint gathers
the split parameters and moments there and holds full arrays, so it
resumes at any world size or degree. The periodic-save, wall-time and
signal triggers are agreed over all ranks at every group boundary
(``lifecycle.stop_consensus``). Replay under several processes, and a
multi-process mesh without a ``data`` axis, are refused as in JAX.

A MoE config under a ``model`` axis is expert parallel (JAX's
``:473-493``): each rank holds its experts of every layer and its heads of
the attention, and prints ``[mesh] expert parallel``; under a ``data``
axis its capped layers route over the global microbatch
(``models/codon_gpt.py::moe_route``). A ``pipe`` axis runs GPipe (JAX's
``:430-471,551-575``, ``parallel/pipeline.py``): each rank builds its
stage's blocks, the group is one whole-group CE, checkpoints record
``train_objective: "group_ce"`` in the merged layout, a resume that would
switch objectives at ``grad_accum_steps`` > 1 raises
``RunLifecycleError``, and every objective but the plain next-token CE
(and MoE) raises JAX's ``ValueError``.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import math
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.data import manifest as manifest_lib
from genomics_lm_torch.data import vocabulary as vocab_lib
from genomics_lm_torch.data.datasets import (
    DevicePrefetcher,
    EpochPlan,
    PackedDataset,
    dataset_length_audit,
    grouped_batches,
)
from genomics_lm_torch.data.replay import GeneratedTerminationReplayDataset
from genomics_lm_torch.models import biophysics
from genomics_lm_torch.models.codon_gpt import CodonGPT, param_count
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.parallel import mesh as mesh_lib
from genomics_lm_torch.parallel import pipeline as pp_lib
from genomics_lm_torch.parallel import tensor_parallel as tpl
from genomics_lm_torch.parallel.data_parallel import DPContext
from genomics_lm_torch.tokenizers.codon import STOP_IDS
from genomics_lm_torch.training import checkpoints as ckpt_lib
from genomics_lm_torch.training import lora as lora_lib
from genomics_lm_torch.training import optim as optim_lib
from genomics_lm_torch.training.config import (
    auto_run_id,
    ensure_path_list,
    normalize_offset_weights,
    normalize_run_id,
    write_meta,
)
from genomics_lm_torch.training.contracts import validate_primary_training_config
from genomics_lm_torch.training.lifecycle import (
    RunLifecycleError,
    capture_rng_state,
    configuration_fingerprint,
    open_run,
    restore_rng_state,
    stop_consensus,
)
from genomics_lm_torch.training.runtime import (
    GracefulPreemption,
    PeriodicCheckpointPolicy,
    PreemptionRequested,
    WallTimeLimitException,
    WallTimer,
    atomic_write,
    device_memory_stats,
)
from genomics_lm_torch.training.train_step import (
    LossConfig,
    make_eval_step,
    make_train_step,
)
from genomics_lm_torch.utils.device import resolve_device
from genomics_lm_torch.utils.weights import (
    attach_from_tree,
    params_to_jax,
    state_dict_from_jax,
)

PAD_ID = 0
LAST = "last.npz"
OPTIMIZER_FORMAT = "torch.optim.AdamW/by-parameter-name/v1"
ADAFACTOR_FORMAT = "adafactor/by-jax-leaf/v1"


def _above_one(v) -> bool:
    return v is not None and int(v) > 1


class NonfiniteGroupLimitError(RuntimeError):
    """Raised when aborted accumulation groups exceed the configured limit."""


# substrings identifying device-memory exhaustion in an error's text, beside
# PyTorch's own type (the JAX trainer's list, from XLA's messages)
OOM_PATTERNS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "OOM",
    "Attempting to allocate",
)


def _is_oom_error(exc: BaseException) -> bool:
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(pattern in text for pattern in OOM_PATTERNS)


def _apply_oom_downscale(config_path: str | None, cfg: dict,
                         contract_bound: bool = False) -> dict | None:
    """Halve batch_size / double grad_accum in the YAML config so the next
    launch fits (parity: reference loop.py:1516-1549). Refuses to touch a
    contract-bound config; returns the rewrite summary or None."""
    batch_size = int(cfg.get("batch_size", 1))
    if contract_bound:
        print("[oom] primary contract is immutable — not rewriting the config",
              file=sys.stderr)
        return None
    if batch_size <= 1:
        print("[oom] batch_size already 1 — cannot downscale further",
              file=sys.stderr)
        return None
    new_batch = max(1, batch_size // 2)
    new_accum = int(cfg.get("grad_accum_steps", 1)) * 2
    summary = {"batch_size": new_batch, "grad_accum_steps": new_accum}
    if config_path and Path(config_path).exists():
        import yaml

        path = Path(config_path)
        doc = yaml.safe_load(path.read_text()) or {}
        doc.update(summary)
        text = yaml.safe_dump(doc, sort_keys=False)
        atomic_write(path, lambda tmp: tmp.write_text(text))
        print(f"[oom] rewrote {path}: batch_size {batch_size}->{new_batch}, "
              f"grad_accum x2 -> {new_accum}", file=sys.stderr)
    else:
        print(f"[oom] retry with batch_size={new_batch} "
              f"grad_accum_steps={new_accum}", file=sys.stderr)
    return summary


class AccumulationHealth:
    """Checkpointable counters for accumulation-group integrity
    (parity: reference loop.py:90-143, group-granular)."""

    def __init__(self):
        self.nonfinite_microbatches = 0
        self.aborted_groups = 0
        self.discarded_finite_microbatches = 0

    def record_abort(self, discarded_finite: int) -> None:
        self.nonfinite_microbatches += 1
        self.aborted_groups += 1
        self.discarded_finite_microbatches += int(discarded_finite)

    def exceeds_limit(self, max_aborted_groups: int) -> bool:
        if max_aborted_groups < 0:
            return False
        return self.aborted_groups > max_aborted_groups

    def state_dict(self) -> dict:
        return {
            "active_microbatches": 0,
            "nonfinite_microbatches": self.nonfinite_microbatches,
            "aborted_groups": self.aborted_groups,
            "discarded_finite_microbatches": self.discarded_finite_microbatches,
        }

    def load_state_dict(self, state: dict | None) -> None:
        state = state or {}
        self.nonfinite_microbatches = int(state.get("nonfinite_microbatches", 0))
        self.aborted_groups = int(state.get("aborted_groups", 0))
        self.discarded_finite_microbatches = int(
            state.get("discarded_finite_microbatches", 0)
        )


def _model_config(cfg: dict, vocab_size: int) -> CodonGPTConfig:
    merged = dict(cfg)
    merged["vocab_size"] = vocab_size
    if merged.get("multi_offset_targets") is None:
        merged["multi_offset_targets"] = ()
    return CodonGPTConfig.from_run_config(merged)


# --- optimizer state in the checkpoint ---------------------------------------


def _param_index_names(bundle, model: torch.nn.Module) -> dict[int, str]:
    """The optimizer ``state_dict``'s parameter index → parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [p for group in bundle.optimizer.param_groups for p in group["params"]]
    return {i: names[id(p)] for i, p in enumerate(order)}


def optimizer_state(bundle, model: torch.nn.Module) -> dict:
    """The optimizer state in the checkpoint's layout: AdamW's keyed by
    parameter name, Adafactor's by JAX leaf path."""
    if isinstance(bundle.optimizer, optim_lib.Adafactor):
        return {"format": ADAFACTOR_FORMAT, "applied_steps": int(bundle.applied_steps),
                **bundle.optimizer.state_dict()}
    index_names = _param_index_names(bundle, model)
    state = bundle.optimizer.state_dict()["state"]
    return {
        "format": OPTIMIZER_FORMAT,
        "applied_steps": int(bundle.applied_steps),
        "state": {index_names[i]: dict(s) for i, s in state.items()},
    }


def load_optimizer_state(bundle, model: torch.nn.Module, saved) -> None:
    """Restore ``optimizer_state``'s output; raises ``RunLifecycleError`` for
    an optimizer state this trainer did not write (a JAX checkpoint holds
    optax's)."""
    if isinstance(saved, dict) and saved.get("format") == ADAFACTOR_FORMAT:
        if not isinstance(bundle.optimizer, optim_lib.Adafactor):
            raise RunLifecycleError("the resume checkpoint holds Adafactor state; this "
                                    "run uses AdamW")
        try:
            bundle.optimizer.load_state_dict(saved)
        except ValueError as exc:
            raise RunLifecycleError(str(exc)) from exc
        bundle.applied_steps = int(saved["applied_steps"])
        return
    if not isinstance(saved, dict) or saved.get("format") != OPTIMIZER_FORMAT:
        raise RunLifecycleError(
            "the resume checkpoint's optimizer state was not written by this "
            f"trainer (expected format {OPTIMIZER_FORMAT!r}; a JAX checkpoint holds "
            "optax state, which cannot be read here). Start a new run with "
            "transfer_from to take its weights.")
    if isinstance(bundle.optimizer, optim_lib.Adafactor):
        raise RunLifecycleError("the resume checkpoint holds AdamW state; this run "
                                "uses Adafactor")
    name_index = {n: i for i, n in _param_index_names(bundle, model).items()}
    unknown = sorted(set(saved["state"]) - set(name_index))
    if unknown:
        raise RunLifecycleError(f"the optimizer state names unknown parameters: {unknown}")
    sd = bundle.optimizer.state_dict()
    sd["state"] = {
        name_index[n]: {k: torch.as_tensor(np.asarray(v)) for k, v in s.items()}
        for n, s in saved["state"].items()
    }
    bundle.optimizer.load_state_dict(sd)
    bundle.applied_steps = int(saved["applied_steps"])


def _local_optimizer_state(saved, bundle, model) -> dict:
    """A full (one-process layout) optimizer state cut to what this rank's
    optimizer holds: under ZeRO-1 its own parameters or leaves, under
    tensor parallelism its slice of each split parameter's moments (of
    each split JAX leaf's statistics, for Adafactor)."""
    tp = getattr(model, "tp", None)
    if (bundle.zero is None and tp is None) or not isinstance(saved, dict):
        return saved
    if saved.get("format") == ADAFACTOR_FORMAT:
        if not isinstance(bundle.optimizer, optim_lib.Adafactor):
            return dict(saved, state={})
        mine = {k: v for k, v in saved["state"].items() if k in bundle.optimizer.state}
        if tp is not None:
            mine = bundle.optimizer.local_state(mine, tp.rank)
        return dict(saved, state=mine)
    if saved.get("format") != OPTIMIZER_FORMAT:
        return saved
    shapes = {n: p.shape for n, p in model.named_parameters()}
    unknown = sorted(set(saved["state"]) - set(shapes))
    if unknown:
        raise RunLifecycleError(f"the optimizer state names unknown parameters: {unknown}")
    mine = set(_param_index_names(bundle, model).values())
    state = {}
    for name, st in saved["state"].items():
        if name not in mine:
            continue
        split = tp.layout.get(name) if tp is not None else None
        state[name] = {k: (tpl.local_slice(torch.as_tensor(np.asarray(v)), split, tp)
                           if np.ndim(v) else v) for k, v in st.items()}
    return dict(saved, state=state)


def _assemble_optimizer_state(pieces: list[dict], layout: dict, tp_size: int) -> dict:
    """The one-process optimizer state from the ranks' pieces (each
    ``{"tp": model-axis rank, "stage": pipe rank, "optimizer":
    optimizer_state(...)}``): ZeRO-1 owners' parts merged, split moments
    joined over the model axis; Adafactor's stacked leaves joined over the
    stages (AdamW's arrive under their full names)."""
    first = pieces[0]["optimizer"]
    if first["format"] == ADAFACTOR_FORMAT:
        # per stage, each leaf's statistics from every model-axis rank, the
        # split ones joined on their split axis (``Adafactor.stat_axes``)
        stages: dict[int, dict[str, dict[int, dict]]] = {}
        axes: dict[str, dict] = {}
        for piece in pieces:
            axes.update(piece.get("stat_axes") or {})
            by_path = stages.setdefault(piece["stage"], {})
            for path, st in piece["optimizer"]["state"].items():
                by_path.setdefault(path, {})[piece["tp"]] = st

        def join(path, by_tp):
            return {k: (np.concatenate([np.asarray(by_tp[t][k]) for t in range(tp_size)],
                                       axis=ax)
                        if (ax := axes.get(path, {}).get(k)) is not None else v)
                    for k, v in by_tp[0].items()}

        merged = [{path: join(path, by_tp) for path, by_tp in stages[s].items()}
                  for s in sorted(stages)]
        return dict(first, state=pp_lib.merge_stage_leaves(merged))
    by_name: dict[str, dict[int, dict]] = {}
    for piece in pieces:
        for name, st in piece["optimizer"]["state"].items():
            by_name.setdefault(name, {})[piece["tp"]] = st
    state = {}
    for name in sorted(by_name):
        parts = by_name[name]
        split = layout.get(name)
        state[name] = {k: (tpl.assemble([torch.as_tensor(parts[t][k]) for t in range(tp_size)],
                                         split, tp_size)
                           if split is not None and np.ndim(v) else v)
                       for k, v in parts[0].items()}
    return dict(first, state=state)


def gather_full_state(model, bundle, model_cfg: CodonGPTConfig, template, mesh):
    """The model tree and optimizer state in the one-process layout, on
    rank 0 ((None, None) on the other ranks; every rank calls this). Each
    rank sends its host copies (its slices under tensor parallelism, its
    stage under pipeline parallelism, its moments under ZeRO-1) and rank 0
    assembles them, the model into ``template`` (its full copy), the stages
    merged (``pipeline.merge_stage_params``). Without a mesh: the live
    model and optimizer."""
    if mesh is None:
        return params_to_jax(model, model_cfg), optimizer_state(bundle, model)
    tp = getattr(model, "tp", None)
    pp = getattr(model, "pp", None)
    n_tp = tp.size if tp is not None else 1
    dp_rank = mesh.axis_rank(mesh_lib.DATA_AXIS)
    sends_state = bundle.zero is not None or dp_rank == 0
    stage = pp.rank if pp is not None else 0
    opt = ckpt_lib._host_tree(optimizer_state(bundle, model)) if sends_state else None
    if pp is not None and opt is not None and opt.get("format") == OPTIMIZER_FORMAT:
        opt["state"] = pp_lib.stage_to_full(opt["state"], stage, pp.layers)
    piece = {
        "tp": tp.rank if tp is not None else 0,
        "stage": stage,
        "model": ({n: p.detach().cpu().clone() for n, p in model.named_parameters()}
                  if (tp is not None or pp is not None) and dp_rank == 0 else None),
        "optimizer": opt,
        "stat_axes": (bundle.optimizer.stat_axes
                      if tp is not None and isinstance(bundle.optimizer, optim_lib.Adafactor)
                      else None),
    }
    pieces = ckpt_lib.gather_to_writer(piece)
    if pieces is None:
        return None, None
    source = model
    layout = tp.layout if tp is not None else {}
    if tp is not None or pp is not None:
        template.load_state_dict(pp_lib.assemble_pieces(pieces, "model", layout, pp),
                                 strict=True)
        source = template
        if pp is not None:  # every stage's split parameters, by their full names
            layout = pp_lib.merge_stage_params([layout] * pp.size, pp.layers)
    opt = _assemble_optimizer_state([pc for pc in pieces if pc["optimizer"] is not None],
                                    layout, n_tp)
    return params_to_jax(source, model_cfg), opt


# --- host reads ---------------------------------------------------------------

GROUP_METRIC_KEYS = ("applied", "finite_microbatches", "nonpad_tokens", "total_loss_sum",
                     "next_loss_sum", "committed_microbatches", "first_loss",
                     "discarded_before_nonfinite")
EVAL_METRIC_KEYS = ("total_loss", "next_loss", "nonpad_tokens", "next_loss_token_sum")


def read_metrics(metrics: dict, keys) -> dict[str, float]:
    """The named 0-dim device metrics as Python floats, in one device→host
    copy (float32 values and int32 counts are exact in float64)."""
    values = torch.stack([metrics[k].to(torch.float64) for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def _to_device(group, device: torch.device):
    return tuple(torch.from_numpy(p).to(device) if isinstance(p, np.ndarray) else p
                 for p in group)


def run_training(
    cfg: dict,
    *,
    config_path: str | None = None,
    resume: str | None = None,
    transfer_from: str | None = None,
    run_root: str | Path = "runs",
    device: str | torch.device | None = None,
    progress_every: int = 200,
    mesh: mesh_lib.Mesh | None = None,
) -> dict:
    """Train a codon LM per the flat run config; returns the final meta dict.

    Runs on ``device`` (default ``cuda``; raises without CUDA unless a
    device is named; under a multi-process ``mesh``, the rank's device of
    ``parallel/mesh.py::initialize_distributed``). Every rank of the mesh
    calls this with the same config."""
    rank, world_size = mesh_lib.world()
    is_writer = rank == 0
    if world_size > 1 and mesh is None:
        raise ValueError(
            "multi-process training requires a mesh spanning all processes; "
            "without one each process would train independently on its shard")
    n_dp = mesh.axis_size(mesh_lib.DATA_AXIS) if mesh is not None else 1
    n_tp = mesh.axis_size(mesh_lib.MODEL_AXIS) if mesh is not None else 1
    n_pp = mesh.axis_size(mesh_lib.PIPE_AXIS) if mesh is not None else 1
    pipeline = n_pp > 1
    if mesh is not None:
        if world_size > 1 and mesh.size != world_size:
            raise ValueError(f"the mesh {mesh.shape} does not span the {world_size} ranks")
        if world_size > 1 and mesh_lib.DATA_AXIS not in mesh.shape:
            raise ValueError(
                "multi-process meshes need a 'data' axis to assemble global "
                "batches from per-rank loader shards")
        if world_size > 1 and bool(cfg.get("replay_loss_enabled", False)):
            raise ValueError(
                "replay loss is not supported under multi-process meshes "
                "(replay batches are fed host-local)")
    elif _above_one(cfg.get("tensor_parallel")):
        raise ValueError("tensor_parallel > 1 needs a mesh with a 'model' axis")
    dp_rank = mesh.axis_rank(mesh_lib.DATA_AXIS) if mesh is not None else 0
    dp = DPContext.from_mesh(mesh)
    device = (mesh_lib.rank_device(device) if world_size > 1 and device is None
              else resolve_device(device))
    # --- primary contract (fail-closed frozen-config validation) ------------
    primary_contract = None
    if cfg.get("primary_training_contract"):
        primary_contract = validate_primary_training_config(cfg)
        cfg = dict(cfg)
        cfg["run_id"] = primary_contract["run_id"]

    run_id = normalize_run_id(cfg.get("run_id")) or auto_run_id(cfg, config_path)
    seed = int(cfg.get("seed", 1337))

    # --- datasets + contracts ----------------------------------------------
    train_paths = ensure_path_list(None, cfg.get("train_npz"), "train_npz")
    val_paths = ensure_path_list(None, cfg.get("val_npz"), "val_npz")
    use_mmap = bool(cfg.get("use_mmap_dataset", False))

    dataset_id = None
    manifest_path = manifest_lib.discover_manifest(train_paths + val_paths)
    if cfg.get("dataset_manifest"):
        manifest_path = Path(cfg["dataset_manifest"])
    if manifest_path is not None:
        manifest = manifest_lib.load_dataset_manifest(
            manifest_path, verify_artifacts=bool(cfg.get("verify_manifest_artifacts", False))
        )
        dataset_id = manifest["dataset"]["id"]
        if bool(cfg.get("require_scientific_valid", False)) and not manifest["dataset"].get(
            "scientific_valid"
        ):
            raise manifest_lib.DatasetManifestError(
                "config requires a scientifically valid dataset manifest"
            )

    contract = vocab_lib.resolve_vocabulary_contract(
        train_paths + val_paths,
        configured_path=cfg.get("itos_path"),
        configured_size=cfg.get("vocab_size"),
    )
    vocab_size = contract.size

    train_ds = PackedDataset(train_paths, use_mmap=use_mmap)
    val_ds = PackedDataset(val_paths, use_mmap=use_mmap)
    block_size = int(cfg["block_size"])

    model_cfg = _model_config(cfg, vocab_size)
    loss_cfg_dict = dict(cfg)
    offsets = cfg.get("multi_offset_targets") or []
    multi_offset_weights = normalize_offset_weights(
        offsets, cfg.get("multi_offset_weights")
    )
    loss_cfg_dict["multi_offset_weights"] = multi_offset_weights
    loss_cfg = LossConfig.from_run_config(loss_cfg_dict, STOP_IDS)
    if pipeline:
        # the pipeline step commits the plain next-token CE only: every
        # other objective fails closed rather than silently training without it
        unsupported = [name for name, on in (
            ("multi_offset_loss", bool(multi_offset_weights)),
            ("termination_loss", loss_cfg.termination_enabled),
            ("replay_loss", loss_cfg.replay_enabled),
            ("shape_guidance", model_cfg.use_shape_guidance),
            ("moe", model_cfg.moe_experts > 0),
        ) if on]
        if unsupported:
            raise ValueError("pipeline parallelism supports the plain next-token CE "
                             f"objective only; disable: {unsupported}")

    # --- run lifecycle -------------------------------------------------------
    fingerprint = configuration_fingerprint(cfg)
    if resume is not None:
        vocab_lib.validate_resume_checkpoint(resume, contract, dataset_id=dataset_id)
    training_run = open_run(
        run_root,
        run_id,
        resume=resume,
        target_epochs=(int(cfg["epochs"]) if str(cfg.get("epochs", "")).strip().isdigit() else None),
        config_fingerprint=fingerprint,
    )
    run_dir = training_run.run_dir
    ckpt_dir = training_run.checkpoints
    scores_dir = training_run.scores
    log_csv = scores_dir / "curves.csv"

    snapshot = None
    if is_writer:  # rank 0 alone writes the run's files
        snapshot = vocab_lib.snapshot_vocabulary(contract, run_dir / "itos.txt")
        vocab_lib.write_vocabulary_manifest(
            contract.provenance(snapshot), run_dir / "vocabulary.json"
        )
    cfg = dict(cfg)
    cfg["vocab_size"] = vocab_size
    cfg["vocabulary"] = {"sha256": contract.sha256, "size": vocab_size}
    if dataset_id is not None:
        cfg["dataset_manifest"] = {"dataset_id": dataset_id}
    if is_writer and config_path and Path(config_path).exists():
        shutil.copy2(config_path, ckpt_dir / "config.yaml")

    print(f"[run] id={run_dir.name} device={device}")
    print(f"[paths] ckpts={ckpt_dir} scores={scores_dir} log_csv={log_csv}")
    print(f"[data] train={len(train_ds)} val={len(val_ds)} windows "
          f"storage={train_ds.storage_mode}")
    print(f"[audit] {dataset_length_audit(train_ds, block_size)}")

    # --- model init / transfer ----------------------------------------------
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CodonGPT(model_cfg)
        # shape guidance: attach the nucleotide encoder + codon one-hot LUT
        shape_lookup = None
        if model_cfg.use_shape_guidance:
            if cfg.get("shape_encoder_checkpoint"):
                enc_payload = ckpt_lib.load_checkpoint(cfg["shape_encoder_checkpoint"])
                encoder_tree = enc_payload.get("encoder", enc_payload.get("model", enc_payload))
                attach_from_tree(model, {"shape_encoder": encoder_tree})
                model.load_state_dict(state_dict_from_jax(
                    dict(params_to_jax(model, model_cfg), shape_encoder=encoder_tree),
                    model_cfg), strict=True)
            else:
                model.shape_encoder = biophysics.ShapeEncoder()
            shape_lookup = torch.from_numpy(biophysics.shape_lookup_table()).to(device)
            print(
                f"[biophysics] shape guidance on; encoder "
                f"{'unfrozen' if cfg.get('unfreeze_encoder') else 'frozen'}"
            )
    n_params = param_count(model)
    print(f"[model] params={n_params} spec={model_cfg.to_dict()}")

    if transfer_from is not None:
        source = ckpt_lib.load_checkpoint(transfer_from)
        source_itos = source.get("cfg", {}).get("itos")
        src_dir = Path(transfer_from).parent.parent
        if source_itos is None and (src_dir / "itos.txt").exists():
            source_itos = list(vocab_lib.load_itos(src_dir / "itos.txt"))
        params, report = ckpt_lib.transfer_load_params(
            params_to_jax(model, model_cfg),
            source["model"],
            source_itos=source_itos,
            target_itos=list(contract.tokens),
            vocab_axis_size=vocab_size,
        )
        model.load_state_dict(state_dict_from_jax(params, model_cfg), strict=True)
        print(
            f"[transfer] loaded={len(report['loaded'])} adapted={len(report['adapted'])} "
            f"skipped={len(report['skipped'])} missing={len(report['missing'])}"
        )
        adaptation = {
            "legacy_adaptation": True,
            "transfer_from": str(transfer_from),
            "loaded": len(report["loaded"]),
            "adapted": len(report["adapted"]),
            "skipped": len(report["skipped"]),
        }
        if is_writer:
            prov = contract.provenance(snapshot)
            prov.update(adaptation)
            vocab_lib.write_vocabulary_manifest(prov, run_dir / "vocabulary.json")

    # --- LoRA (after transfer, so adapters wrap the loaded base weights) ----
    if cfg.get("lora_rank"):
        tree = lora_lib.add_lora_adapters(
            params_to_jax(model, model_cfg),
            np.random.default_rng(seed),
            rank=int(cfg["lora_rank"]),
            alpha=float(cfg["lora_alpha"]) if cfg.get("lora_alpha") else None,
            targets=str(cfg.get("lora_targets", "attn")),
        )
        attach_from_tree(model, tree)
        model.load_state_dict(state_dict_from_jax(tree, model_cfg), strict=True)
        n_params = param_count(model)
        print(
            f"[lora] rank={cfg['lora_rank']} targets={cfg.get('lora_targets', 'attn')} "
            f"trainable={lora_lib.lora_param_count(tree)} "
            f"lora_only={bool(cfg.get('lora_only', True))}"
        )
    model.to(device)

    # --- mesh: a pipeline stage's blocks; Megatron and expert splits over the
    # model axis -------------------------------------------------------------
    template = None  # rank 0's full copy, which checkpoints assemble into
    if is_writer and (n_tp > 1 or pipeline):
        template = copy.deepcopy(model).cpu()
    if pipeline:
        pp_lib.stage_model(model, pp_lib.PPContext.from_mesh(mesh, model_cfg.n_layer))
    if n_tp > 1:
        if cfg.get("residual_sharding"):
            model_cfg = model_cfg.replace(residual_sharding=tuple(cfg["residual_sharding"]))
            model.cfg = model_cfg
        tpl.shard_model(model, tpl.TPContext.from_mesh(mesh))
    if mesh is not None:
        print(f"[mesh] shape={mesh.shape} world={world_size} rank={rank} "
              f"backend={mesh_lib.backend()} device={device} "
              f"sequence_parallel={bool(n_tp > 1 and model.tp.sequence_parallel)} "
              f"zero1={bool(cfg.get('shard_optimizer_state', False) and n_dp > 1)}")
        if model_cfg.moe_experts and n_tp > 1:
            print(f"[mesh] expert parallel: experts={model_cfg.moe_experts} "
                  f"over model={n_tp}")
        if pipeline:
            print(f"[mesh] pipeline: pipe={n_pp} data={n_dp} model={n_tp} "
                  f"layers_per_stage={model_cfg.n_layer // n_pp} "
                  f"microbatches_per_group={int(cfg.get('grad_accum_steps', 16))} "
                  f"zero1={bool(cfg.get('shard_optimizer_state', False))}")

    # --- optimizer / schedule ----------------------------------------------
    batch_size = int(cfg["batch_size"])
    if batch_size % n_dp:
        raise ValueError(
            f"batch_size {batch_size} must divide over {n_dp} data-parallel ranks")
    gacc = int(cfg.get("grad_accum_steps", 16))
    max_nonfinite_groups = int(cfg.get("max_nonfinite_accumulation_groups", 3))
    if max_nonfinite_groups < -1:
        raise ValueError("max_nonfinite_accumulation_groups must be -1 or greater")

    plan_probe = EpochPlan(
        train_ds, batch_size=batch_size, seed=seed, epoch=1,
        bucket_batching=bool(cfg.get("bucket_batching", False)),
    )
    microbatches_per_epoch = len(plan_probe)
    steps_per_epoch = math.ceil(microbatches_per_epoch / max(1, gacc))
    max_epochs = optim_lib.resolve_epochs(
        cfg, n_params, len(train_ds) * block_size
    )
    computed_total = max(1, steps_per_epoch * max_epochs)
    total_steps = int(cfg.get("scheduler_total_steps", computed_total))
    bundle = optim_lib.build_optimizer(cfg, model, total_steps, dp=dp)
    cfg["resolved_warmup_steps"] = bundle.warmup_steps

    # --- replay --------------------------------------------------------------
    replay_iter = None
    replay_every = int(cfg.get("replay_every_microbatches", 4) or 4)
    if loss_cfg.replay_enabled:
        replay_ds = GeneratedTerminationReplayDataset(cfg["replay_data"], block_size)
        replay_iter = replay_ds.batches(
            int(cfg.get("replay_batch_size", batch_size)), seed=seed
        )

    if pipeline:
        train_step = pp_lib.make_pipeline_group_step(model_cfg, model.pp, dp=dp)
        eval_step = pp_lib.make_pipeline_eval_step(model_cfg, model.pp, dp=dp)
    else:
        train_step = make_train_step(model_cfg, loss_cfg, use_replay=loss_cfg.replay_enabled,
                                     shape_lookup=shape_lookup, dp=dp)
        eval_step = make_eval_step(model_cfg, loss_cfg, shape_lookup=shape_lookup, dp=dp)
    train_objective = "group_ce" if pipeline else "microbatch_mean"
    group_keys = GROUP_METRIC_KEYS + tuple(
        [f"offset_{o}_sum" for o in multi_offset_weights]
        + (["term_loss_sum"] if loss_cfg.termination_enabled else [])
        + (["replay_loss_sum", "replay_count"] if loss_cfg.replay_enabled else []))
    eval_keys = EVAL_METRIC_KEYS + tuple(
        [f"offset_{o}" for o in multi_offset_weights]
        + (["term_loss"] if loss_cfg.termination_enabled else []))
    # draws every dropout mask and attention seed; its state is checkpointed.
    # Data-parallel ranks draw distinct streams; the ranks of one model axis
    # share theirs (their replicated activations take the same masks).
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + dp_rank)

    # --- resume --------------------------------------------------------------
    start_epoch = 0
    best = float("inf")
    best_epoch = -1
    no_improve = 0
    step = 0
    consumed_train_tokens = 0
    resume_microbatch_idx = 0
    health = AccumulationHealth()

    def fresh_epoch_metrics() -> dict:
        m = {"total_loss_sum": 0.0, "next_loss_sum": 0.0, "microbatches": 0,
             "initial_loss": None}
        # the auxiliary objectives' sums ride in the checkpoint too, so a
        # mid-epoch resume reports the whole epoch (the JAX trainer restarts
        # them at the resume, ROADMAP.md §3)
        m.update({f"offset_{o}_sum": 0.0 for o in multi_offset_weights})
        if loss_cfg.termination_enabled:
            m["term_loss_sum"] = 0.0
        if loss_cfg.replay_enabled:
            m.update(replay_loss_sum=0.0, replay_count=0)
        return m

    epoch_train_metrics = fresh_epoch_metrics()
    history: list[dict] = []
    runtime_memory = {"device_peak_bytes": 0}

    if training_run.resume_checkpoint is not None:
        payload = ckpt_lib.load_checkpoint(training_run.resume_checkpoint)
        try:
            saved_objective = payload.get("train_objective")
            if saved_objective and saved_objective != train_objective and gacc > 1:
                raise RunLifecycleError(
                    "resume would switch the training objective from "
                    f"{saved_objective} to {train_objective} at grad_accum_steps={gacc}: "
                    "whole-group CE and mean-of-microbatch-means weight ragged "
                    "microbatches differently. Resume with the same pipeline_stages "
                    "setting (any stage COUNT is fine), or use grad_accum_steps: 1 "
                    "where the objectives coincide."
                )
            full = state_dict_from_jax(payload["model"], model_cfg)
            saved_opt = payload.get("optimizer")
            if pipeline:  # checkpoints hold the merged layout: this stage's part
                pp = model.pp
                full = pp_lib.split_stage_params(full, model_cfg.n_layer, pp.size, pp.rank)
                if isinstance(saved_opt, dict) and saved_opt.get("format") == OPTIMIZER_FORMAT:
                    saved_opt = dict(saved_opt, state=pp_lib.split_stage_params(
                        saved_opt["state"], model_cfg.n_layer, pp.size, pp.rank))
                elif isinstance(saved_opt, dict) and saved_opt.get("format") == ADAFACTOR_FORMAT:
                    saved_opt = dict(saved_opt, state=pp_lib.split_stage_leaves(
                        saved_opt["state"], pp.first_layer, pp.layers))
            tpl.load_full_state(model, full)
            load_optimizer_state(bundle, model,
                                 _local_optimizer_state(saved_opt, bundle, model))
            restore_rng_state(payload.get("rng_state"), generator)
            if dp_rank:  # rank 0's saved stream, made distinct for this rank
                draw = torch.randint(0, 2**62, (1,), generator=generator, device=device)
                generator.manual_seed(int(draw.item()) + dp_rank)
        except Exception:
            training_run.close()  # release the run lock before failing closed
            raise
        step = int(payload["step"])
        start_epoch = int(payload["run_progress"]["completed_epochs"])
        best = float(payload.get("best_val", float("inf")))
        best_epoch = int(payload.get("best_epoch", -1))
        no_improve = int(payload.get("no_improve", 0))
        consumed_train_tokens = int(payload.get("consumed_train_tokens", 0))
        health.load_state_dict(payload.get("accumulation_health"))
        if (
            int(payload.get("batch_size", batch_size)) == batch_size
            and int(payload.get("grad_accum_steps", gacc)) == gacc
        ):
            resume_microbatch_idx = int(payload.get("epoch_microbatch_idx", 0))
        else:
            print("[resume] batch_size/grad_accum changed; dropping mid-epoch position")
        saved_metrics = payload.get("epoch_train_metrics")
        if saved_metrics and resume_microbatch_idx:
            epoch_train_metrics.update(saved_metrics)
        if bundle.plateau is not None and payload.get("scheduler"):
            bundle.plateau.load_state_dict(payload["scheduler"])
        print(
            f"[resume] epoch={start_epoch} step={step} microbatch={resume_microbatch_idx}"
        )

    periodic_ckpt = PeriodicCheckpointPolicy(
        every_steps=int(cfg.get("checkpoint_every_steps", 0) or 0),
        every_minutes=float(cfg.get("checkpoint_every_minutes", 0.0) or 0.0),
        last_saved_step=step,
    )

    current_epoch_idx = start_epoch
    current_resume_microbatch_idx = resume_microbatch_idx

    def make_checkpoint_payload(epoch_idx: int, **metrics) -> dict | None:
        """The checkpoint payload, on rank 0 (None on the other ranks);
        every rank calls it."""
        val_loss = metrics.get("val_loss", float("inf"))
        epoch_complete = val_loss != float("inf")
        model_tree, opt_state = gather_full_state(model, bundle, model_cfg, template, mesh)
        if not is_writer:
            return None
        return {
            "model": model_tree,
            "optimizer": opt_state,
            "scheduler": bundle.plateau.state_dict() if bundle.plateau else None,
            "cfg": {k: v for k, v in cfg.items() if _jsonable(v)},
            "epoch": epoch_idx if epoch_complete else max(0, epoch_idx - 1),
            "val_loss": val_loss,
            "train_loss": metrics.get("train_loss", float("inf")),
            "train_next_loss": metrics.get("train_next_loss"),
            "val_next_loss": metrics.get("val_next_loss"),
            "train_term_loss": metrics.get("train_term_loss"),
            "val_term_loss": metrics.get("val_term_loss"),
            "train_replay_term_loss": metrics.get("train_replay_term_loss"),
            "best_val": best,
            "best_epoch": best_epoch,
            "no_improve": no_improve,
            "step": step,
            "consumed_train_tokens": int(consumed_train_tokens),
            "runtime_memory": dict(runtime_memory),
            "epoch_microbatch_idx": (
                0 if epoch_complete else int(current_resume_microbatch_idx)
            ),
            "batch_size": batch_size,
            "grad_accum_steps": gacc,
            "train_objective": train_objective,
            "train_examples": len(train_ds),
            "train_batches": microbatches_per_epoch,
            "accumulation_health": health.state_dict(),
            "max_nonfinite_accumulation_groups": max_nonfinite_groups,
            "epoch_train_metrics": dict(epoch_train_metrics),
            "run_progress": {
                "completed_epochs": epoch_idx if epoch_complete else max(0, epoch_idx - 1),
                "current_epoch": epoch_idx,
                "microbatch": 0 if epoch_complete else int(current_resume_microbatch_idx),
                "optimizer_step": step,
            },
            "rng_state": capture_rng_state(generator),
            "run_fingerprint": fingerprint,
        }

    async_ckpt = (
        ckpt_lib.AsyncCheckpointer() if bool(cfg.get("async_checkpointing", False))
        else None
    )

    def write_ckpt(payload, path) -> None:
        if payload is None:  # not rank 0
            return
        if async_ckpt is not None:
            async_ckpt.save(payload, path)
        else:
            ckpt_lib.save_checkpoint(payload, path)

    def save_last(epoch_idx: int, reason: str, **metrics) -> None:
        payload = make_checkpoint_payload(epoch_idx, **metrics)
        if payload is not None:
            payload["checkpoint_reason"] = reason
        write_ckpt(payload, ckpt_dir / LAST)
        periodic_ckpt.mark_saved(step)
        print(f"[checkpoint] saved {ckpt_dir / LAST} reason={reason} step={step}")

    max_time_minutes = cfg.get("max_time_minutes")
    wall_timer = WallTimer(max_time_minutes)
    preemption = GracefulPreemption().install()
    train_wall0 = time.perf_counter()
    train_cpu0 = time.process_time()
    dataloader_seed = int(cfg.get("dataloader_seed", seed))
    base_lr = float(cfg.get("lr", 5e-6))

    def lr_of_step(s: int) -> float:
        if bundle.schedule_name == "cosine":
            return base_lr * bundle.lr_lambda(s)
        return base_lr * bundle.plateau.scale(s)

    def run_validation(epoch_idx: int):
        plan = EpochPlan(
            val_ds, batch_size=batch_size, seed=dataloader_seed, epoch=0, shuffle=False,
            bucket_batching=bool(cfg.get("bucket_batching", False)),
        )
        rows = []
        # several data-parallel ranks: each evaluates its strided rows of every
        # batch, padded to equal shares (PAD rows carry no targets), and
        # skips none another rank evaluates
        for x, y in plan.microbatches(host_id=dp_rank, n_hosts=n_dp,
                                      pad_equal_shards=n_dp > 1):
            if x.shape[0] == 0:
                continue
            xb, yb = _to_device((x, y), device)
            out = eval_step(model, xb.long(), yb.long())
            rows.append(torch.stack([out[k].to(torch.float64) for k in eval_keys]))
        sums: dict[str, float] = {}
        values = torch.stack(rows).cpu().tolist() if rows else []  # one host read
        for row in values:
            for k, v in zip(eval_keys, row):
                sums[k] = sums.get(k, 0.0) + v
        n = max(len(values), 1)
        avg = {k: v / n for k, v in sums.items()}
        avg["microbatches"] = n
        # exact token-weighted corpus NLL for perplexity parity
        if sums.get("nonpad_tokens"):
            avg["nll_token_weighted"] = sums["next_loss_token_sum"] / sums["nonpad_tokens"]
        return avg

    status = "completed"
    failure: Exception | None = None
    try:
        if start_epoch >= max_epochs:
            print(
                f"[resume] start_epoch {start_epoch} >= epochs {max_epochs}; "
                "no new epochs will run unless you increase 'epochs'."
            )
        print(
            f"[train] starting: epochs={max_epochs}, steps_per_epoch={steps_per_epoch}, "
            f"total_steps={total_steps}, batch_size={batch_size}, grad_accum={gacc}, "
            f"scheduler={bundle.schedule_name}"
        )
        for epoch in range(start_epoch, max_epochs):
            epoch_idx = epoch + 1
            current_epoch_idx = epoch_idx
            ep_wall0 = time.perf_counter()
            skip = resume_microbatch_idx if epoch == start_epoch else 0
            resume_microbatch_idx = 0
            if skip == 0:
                epoch_train_metrics.update(fresh_epoch_metrics())
            else:
                # group-aligned resume
                skip = (skip // gacc) * gacc
                print(f"[resume] skipping {skip}/{microbatches_per_epoch} applied microbatches")

            plan = EpochPlan(
                train_ds, batch_size=batch_size, seed=dataloader_seed, epoch=epoch_idx,
                bucket_batching=bool(cfg.get("bucket_batching", False)),
            )
            mb_seen = 0
            epoch_start = time.perf_counter()

            prefetch_depth = int(cfg.get("prefetch_batches", 2))
            raw_groups = grouped_batches(
                plan, gacc, host_id=dp_rank, n_hosts=n_dp, skip_microbatches=skip,
                pad_batch_to=batch_size // n_dp,
            )
            stage = lambda g: (g[0], g[1], g[2], g[0].shape[0])  # noqa: E731
            if prefetch_depth:
                # a worker thread stages each group on the device from pinned
                # memory, overlapping the copy with the running step
                batch_iter = DevicePrefetcher(raw_groups, stage, depth=prefetch_depth,
                                              device=device)
            else:
                batch_iter = (_to_device(stage(g), device) for g in raw_groups)
            with contextlib.closing(batch_iter):
                for bx, by, mb_index, n_mb in batch_iter:
                    batch = {"x": bx.long(), "y": by.long()}
                    if loss_cfg.replay_enabled:
                        # one replay batch a group, on every replay_every-th microbatch
                        batch["replay_mask"] = [
                            (mb_index - n_mb + j + 1) % replay_every == 0
                            for j in range(n_mb)]
                        rx, rlabels = next(replay_iter)
                        batch["replay_x"] = torch.from_numpy(rx).to(device).long()
                        batch["replay_labels"] = torch.from_numpy(rlabels).to(device).long()
                    lr_scale = 1.0 if bundle.plateau is None else bundle.plateau.scale(step)
                    metrics = read_metrics(
                        train_step(model, bundle, batch, generator, lr_scale), group_keys)
                    applied = bool(metrics["applied"])
                    if applied:
                        step += 1
                        consumed_train_tokens += int(metrics["nonpad_tokens"])
                        epoch_train_metrics["total_loss_sum"] += metrics["total_loss_sum"]
                        epoch_train_metrics["next_loss_sum"] += metrics["next_loss_sum"]
                        epoch_train_metrics["microbatches"] += int(
                            metrics["committed_microbatches"])
                        if epoch_train_metrics["initial_loss"] is None:
                            epoch_train_metrics["initial_loss"] = metrics["first_loss"]
                            print(f"[train] initial_loss={epoch_train_metrics['initial_loss']:.6f}")
                        for key in ([f"offset_{o}_sum" for o in multi_offset_weights]
                                    + (["term_loss_sum"] if loss_cfg.termination_enabled
                                       else [])
                                    + (["replay_loss_sum"] if loss_cfg.replay_enabled
                                       else [])):
                            epoch_train_metrics[key] += metrics[key]
                        if loss_cfg.replay_enabled:
                            epoch_train_metrics["replay_count"] += int(metrics["replay_count"])
                    else:
                        discarded = int(metrics["discarded_before_nonfinite"])
                        health.record_abort(discarded)
                        print(
                            "[train] aborted nonfinite accumulation group at "
                            f"microbatch={mb_index}; discarded_finite_microbatches={discarded} "
                            f"aborted_groups={health.aborted_groups}"
                        )
                        if health.exceeds_limit(max_nonfinite_groups):
                            raise NonfiniteGroupLimitError(
                                "nonfinite accumulation groups exceeded configured maximum "
                                f"{max_nonfinite_groups}: {health.aborted_groups}"
                            )
                    current_resume_microbatch_idx = mb_index
                    mb_seen += n_mb
                    if progress_every and mb_seen and mb_seen % progress_every < n_mb:
                        elapsed = time.perf_counter() - epoch_start
                        print(
                            f"[train] progress: {mb_index}/{microbatches_per_epoch} "
                            f"speed: {mb_seen * batch_size / max(elapsed, 1e-9):.2f} seq/sec"
                        )
                    periodic_due = applied and periodic_ckpt.should_save(step)
                    if hasattr(wall_timer, "expired"):
                        wall_due = wall_timer.expired()
                    elif world_size == 1:
                        # duck-typed fake timers (tests monkeypatch
                        # loop.WallTimer) raise from check() directly; only
                        # in one process, where a raise parts no collective
                        wall_timer.check()
                        wall_due = False
                    else:
                        raise TypeError(
                            "multi-process training requires a wall timer with a "
                            "non-raising expired() probe (trigger decisions go "
                            "through the rank consensus)")
                    preempt_due = preemption.requested
                    periodic_due, wall_due, preempt_due = stop_consensus(
                        periodic_due, wall_due, preempt_due, device)
                    if periodic_due:
                        save_last(epoch_idx, reason="periodic")
                    if wall_due:
                        raise WallTimeLimitException()
                    if preempt_due:
                        preemption.check()
                        raise PreemptionRequested("preempted on a peer rank")

            mem = device_memory_stats(device)
            if mem.get("peak_bytes_in_use"):
                runtime_memory["device_peak_bytes"] = max(
                    runtime_memory["device_peak_bytes"], mem["peak_bytes_in_use"]
                )

            n_train = max(epoch_train_metrics["microbatches"], 1)
            train_loss = epoch_train_metrics["total_loss_sum"] / n_train
            train_next_loss = epoch_train_metrics["next_loss_sum"] / n_train
            train_term_loss = (epoch_train_metrics["term_loss_sum"] / n_train
                               if loss_cfg.termination_enabled else None)
            train_replay_loss = (
                epoch_train_metrics["replay_loss_sum"]
                / max(epoch_train_metrics["replay_count"], 1)
                if loss_cfg.replay_enabled else None)
            train_offsets = {o: epoch_train_metrics[f"offset_{o}_sum"] / n_train
                             for o in multi_offset_weights}

            val = run_validation(epoch_idx)
            val_loss = val.get("total_loss", float("inf"))
            val_next_loss = val.get("next_loss", float("inf"))
            val_term_loss = val.get("term_loss")
            val_offsets = {o: val.get(f"offset_{o}", 0.0) for o in multi_offset_weights}
            ppl = math.exp(min(20.0, val_next_loss))

            if bundle.plateau is not None:
                bundle.plateau.step_metric(val_loss)
            lr_now = lr_of_step(max(step - 1, 0))

            msg = (
                f"[epoch {epoch_idx}] train {train_loss:.3f} | val {val_loss:.3f} "
                f"| next_val {val_next_loss:.3f} | ppl {ppl:.2f} | lr {lr_now:.2e}"
            )
            if health.aborted_groups:
                msg += (
                    f" | aborted_groups={health.aborted_groups} "
                    f"discarded_finite_microbatches={health.discarded_finite_microbatches}"
                )
            if multi_offset_weights:
                msg += " | offsets " + " ".join(
                    f"o{o}:train={train_offsets.get(o, 0.0):.3f}/val={val_offsets.get(o, 0.0):.3f}"
                    for o in sorted(multi_offset_weights)
                )
            if loss_cfg.termination_enabled:
                msg += f" | term train={train_term_loss:.3f}/val={val_term_loss:.3f}"
            if loss_cfg.replay_enabled:
                msg += f" | replay_term train={train_replay_loss:.3f}"
            print(msg)
            print(
                f"[timing] epoch {epoch_idx} wall_sec={time.perf_counter() - ep_wall0:.2f}"
            )

            improved = val_loss + 1e-6 < best
            if improved:
                best = val_loss
                best_epoch = epoch_idx
                no_improve = 0
            else:
                no_improve += 1

            epoch_metrics = dict(
                train_loss=train_loss, val_loss=val_loss,
                train_next_loss=train_next_loss, val_next_loss=val_next_loss,
                train_term_loss=train_term_loss, val_term_loss=val_term_loss,
                train_replay_term_loss=train_replay_loss,
            )
            payload = make_checkpoint_payload(epoch_idx, **epoch_metrics)
            if async_ckpt is not None:
                # a periodic save of last.npz may still be writing through the
                # same staging file: join it before this synchronous save
                async_ckpt.wait()
            # the epoch's other checkpoints hold last.npz's payload: linked to it
            if is_writer:
                ckpt_lib.save_checkpoint(payload, ckpt_dir / LAST)
            periodic_ckpt.mark_saved(step)
            if is_writer and cfg.get("save_epochs", False):
                ckpt_lib.link_checkpoint(ckpt_dir / LAST, ckpt_dir / f"epoch_{epoch_idx}.npz")

            if is_writer:
                write_header = not log_csv.exists()
                with log_csv.open("a", newline="") as f:
                    writer = csv.writer(f)
                    if write_header:
                        header = ["epoch", "train_loss", "val_loss", "train_next_loss",
                                  "val_next_loss", "perplexity", "lr"]
                        for o in sorted(multi_offset_weights):
                            header += [f"train_offset_{o}", f"val_offset_{o}"]
                        if loss_cfg.termination_enabled:
                            header += ["train_term_loss", "val_term_loss"]
                        if loss_cfg.replay_enabled:
                            header += ["train_replay_term_loss"]
                        writer.writerow(header)
                    row = [
                        epoch_idx, f"{train_loss:.4f}", f"{val_loss:.4f}",
                        f"{train_next_loss:.4f}", f"{val_next_loss:.4f}",
                        f"{ppl:.3f}", f"{lr_now:.3e}",
                    ]
                    for o in sorted(multi_offset_weights):
                        row += [f"{train_offsets.get(o, 0.0):.4f}", f"{val_offsets.get(o, 0.0):.4f}"]
                    if loss_cfg.termination_enabled:
                        row += [f"{train_term_loss:.4f}", f"{val_term_loss:.4f}"]
                    if loss_cfg.replay_enabled:
                        row += [f"{train_replay_loss:.4f}"]
                    writer.writerow(row)

            history.append({
                "epoch": epoch_idx,
                "train_loss": train_loss,
                "val_loss": val_loss,
                "train_next_loss": train_next_loss,
                "val_next_loss": val_next_loss,
                "train_term_loss": train_term_loss,
                "val_term_loss": val_term_loss,
                "train_replay_term_loss": train_replay_loss,
                "perplexity": ppl,
                "lr": lr_now,
                "nonfinite_microbatches": health.nonfinite_microbatches,
                "aborted_accumulation_groups": health.aborted_groups,
                "discarded_finite_microbatches": health.discarded_finite_microbatches,
            })

            if improved:
                if is_writer:
                    for name in ("best.npz", f"best_epoch_{epoch_idx:03d}.npz"):
                        ckpt_lib.link_checkpoint(ckpt_dir / LAST, ckpt_dir / name)
            elif int(cfg.get("early_stop_patience", 5)) > 0 and no_improve >= int(
                cfg.get("early_stop_patience", 5)
            ):
                print("[early-stopping] no improvement; stopping.")
                break

    except PreemptionRequested as exc:
        print(f"\n[info] {exc} — saving preemption checkpoint mid-epoch.")
        save_last(current_epoch_idx or (start_epoch + 1), reason="preempted")
        status = "stopped"
    except WallTimeLimitException:
        print(f"\n[info] Wall-time limit of {max_time_minutes} minutes reached mid-epoch.")
        save_last(current_epoch_idx or (start_epoch + 1), reason="wall_time")
        status = "stopped"
    except NonfiniteGroupLimitError as exc:
        save_last(current_epoch_idx or (start_epoch + 1), reason="nonfinite_group_limit")
        status = "failed"
        failure = exc
    except Exception as exc:
        if _is_oom_error(exc):
            print("\n[oom] device memory exhausted", file=sys.stderr)
            try:
                save_last(current_epoch_idx or (start_epoch + 1), reason="oom")
            except Exception as save_exc:  # the checkpoint itself may not fit
                print(f"[oom] checkpoint save failed: {save_exc}", file=sys.stderr)
            if is_writer:
                _apply_oom_downscale(config_path, cfg,
                                     contract_bound=primary_contract is not None)
            status = "stopped"
            failure = exc
        else:
            status = "failed"
            failure = exc
            print(f"[error] training failed: {exc}", file=sys.stderr)
    finally:
        # restore prior signal handlers even on BaseException unwinds, so a
        # later SIGTERM is never swallowed by a stale flag-only handler
        preemption.uninstall()

    total_time = time.perf_counter() - train_wall0
    meta = {
        "run_id": run_dir.name,
        "train_wall_sec": round(total_time, 2),
        "train_cpu_sec": round(time.process_time() - train_cpu0, 2),
        "best_epoch": best_epoch,
        "best_val_loss": float(best) if best != float("inf") else None,
        "status": status,
        "accumulation_health": health.state_dict(),
        "model_spec": model_cfg.to_dict(),
        "n_params": n_params,
        "consumed_train_tokens": int(consumed_train_tokens),
        "runtime_memory": dict(runtime_memory),
        "device": str(device),
    }
    if failure is not None:
        meta["error"] = f"{type(failure).__name__}: {failure}"
    if preemption.requested:
        meta["preempted_by_signal"] = preemption.signum
    if history:
        meta.update({
            "last_epoch": history[-1]["epoch"],
            "last_val_loss": history[-1]["val_loss"],
            "last_train_loss": history[-1]["train_loss"],
            "last_val_next_loss": history[-1].get("val_next_loss"),
            "last_train_next_loss": history[-1].get("train_next_loss"),
            "last_val_term_loss": history[-1].get("val_term_loss"),
            "last_train_term_loss": history[-1].get("train_term_loss"),
            "last_train_replay_term_loss": history[-1].get("train_replay_term_loss"),
            "last_perplexity": history[-1]["perplexity"],
        })
        if is_writer:
            (scores_dir / "metrics.json").write_text(json.dumps(meta, indent=2) + "\n")
    if is_writer:
        write_meta(ckpt_dir, meta)
    if status == "completed" and history:
        training_run.mark_complete({
            "run_id": run_dir.name,
            "completed_epochs": history[-1]["epoch"],
            "best_epoch": best_epoch,
            "best_validation_loss": meta["best_val_loss"],
        })
    if async_ckpt is not None:
        async_ckpt.close()  # join the in-flight checkpoint write
    training_run.close()
    print(f"[timing] train_wall_sec={total_time:.2f}")
    if failure is not None and status == "failed":
        # OOM ends as status "stopped" (checkpoint saved, config downscaled)
        # and returns meta like a wall-time stop instead of re-raising
        raise failure
    return meta


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


__all__ = [
    "ADAFACTOR_FORMAT",
    "AccumulationHealth",
    "NonfiniteGroupLimitError",
    "OPTIMIZER_FORMAT",
    "gather_full_state",
    "run_training",
]
