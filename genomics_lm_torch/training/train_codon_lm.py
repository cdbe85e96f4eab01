"""Command line of the port's codon-LM trainer (twin of ``scripts/train_codon_lm.py``).

The same flags and the same YAML handling as the JAX script: the config's
``data:`` sub-map merges into the flat namespace, and the path, run-id,
resume, transfer and wall-time flags override it. ``--device`` picks the
device (default: the CUDA card; the run raises without one unless
``--device cpu`` is given).

The mesh flags are JAX's (``scripts/train_codon_lm.py:61-88``), over one
process per rank: ``--mesh_devices N`` (it must equal the world size) lays
a ``data`` axis over the ranks, ``--tensor_parallel T`` a ``model`` axis of
T inside it (``{"data": -1, "model": T}``; on a MoE config the experts
split over it), ``--pipeline_stages S`` a ``pipe`` axis (``{"data": -1,
"pipe": S}``), and both ``{"data": -1, "model": T, "pipe": S}``, DP
outermost and TP inside each stage. Launched by ``torchrun``, each rank
joins the process group strictly (a rank that cannot join raises) and
runs on ``cuda:{LOCAL_RANK}`` over NCCL; ``--device`` puts every rank on
one device (gloo, e.g. ranks sharing one card, or ``--device cpu``).

    python -m genomics_lm_torch.training.train_codon_lm --config cfg.yaml [--run_root runs]
    torchrun --nproc_per_node 2 -m genomics_lm_torch.training.train_codon_lm \
        --config cfg.yaml --mesh_devices 2 [--tensor_parallel 2]
    torchrun --nproc_per_node 8 -m genomics_lm_torch.training.train_codon_lm \
        --config cfg.yaml --mesh_devices 8 --pipeline_stages 4 [--tensor_parallel 2]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train a codon LM with the PyTorch port")
    ap.add_argument("--config", required=True)
    ap.add_argument("--run_id", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--transfer_from", default=None)
    ap.add_argument("--train_npz", nargs="*", default=None)
    ap.add_argument("--val_npz", nargs="*", default=None)
    ap.add_argument("--test_npz", nargs="*", default=None)
    ap.add_argument("--save_epochs", action="store_true")
    ap.add_argument("--max_time_minutes", type=float, default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--mesh_devices", type=int, default=None,
                    help="ranks of the mesh; must equal the world size")
    ap.add_argument("--tensor_parallel", type=int, default=None,
                    help="size of the model (Megatron) axis")
    ap.add_argument("--pipeline_stages", type=int, default=None,
                    help="size of the pipe (GPipe) axis")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.training.config import load_yaml_config
    from genomics_lm_torch.training.loop import run_training

    cfg = load_yaml_config(args.config)
    if args.run_id:
        cfg["run_id"] = args.run_id
    if args.train_npz:
        cfg["train_npz"] = args.train_npz
    if args.val_npz:
        cfg["val_npz"] = args.val_npz
    if args.test_npz:
        cfg["test_npz"] = args.test_npz
    if args.save_epochs:
        cfg["save_epochs"] = True
    if args.max_time_minutes is not None:
        cfg["max_time_minutes"] = args.max_time_minutes
    if args.transfer_from:
        cfg["transfer_from"] = args.transfer_from
    meta = run_training(
        cfg,
        config_path=args.config,
        resume=args.resume,
        transfer_from=cfg.get("transfer_from"),
        run_root=args.run_root,
        device=args.device,
        mesh=launch_mesh(args, cfg),
    )
    # a preempted run saved its checkpoint; exit with the conventional
    # 128+signum so supervisors see the termination cause
    if meta and meta.get("preempted_by_signal"):
        return 128 + int(meta["preempted_by_signal"])
    return 0


def launch_mesh(args, cfg: dict):
    """The mesh of the mesh flags (or the config's keys), or None: under a
    launcher (``WORLD_SIZE`` > 1) the process group is joined first."""
    from genomics_lm_torch.parallel import mesh as mesh_lib

    n_mesh = args.mesh_devices or cfg.get("mesh_devices")
    tp = int(args.tensor_parallel or cfg.get("tensor_parallel") or 1)
    pp = int(args.pipeline_stages or cfg.get("pipeline_stages") or 1)
    if not n_mesh and tp == 1 and pp == 1:
        return None
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        mesh_lib.initialize_distributed(strict=True, device=args.device)
    _, world = mesh_lib.world()
    if n_mesh and int(n_mesh) != world:
        raise ValueError(
            f"--mesh_devices {n_mesh} must equal the world size {world}: launch one "
            f"process per rank (torchrun --nproc_per_node {n_mesh} ...)")
    # JAX's axes (scripts/train_codon_lm.py:61-87): DP outermost, then TP
    # inside each pipeline stage
    axes = {mesh_lib.DATA_AXIS: -1}
    if tp > 1:
        axes[mesh_lib.MODEL_AXIS] = tp
    if pp > 1:
        axes[mesh_lib.PIPE_AXIS] = pp
    return mesh_lib.make_mesh(axes=axes)


if __name__ == "__main__":
    raise SystemExit(main())
