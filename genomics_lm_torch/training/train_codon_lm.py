"""Command line of the port's codon-LM trainer (twin of ``scripts/train_codon_lm.py``).

The same flags and the same YAML handling as the JAX script: the config's
``data:`` sub-map merges into the flat namespace, and the path, run-id,
resume, transfer and wall-time flags override it. ``--device`` picks the
device (default: the CUDA card; the run raises without one unless
``--device cpu`` is given). The mesh flags (``--mesh_devices``,
``--tensor_parallel``, ``--pipeline_stages``) are accepted and raise
``NotImplementedError``: the port trains on one device.

    python -m genomics_lm_torch.training.train_codon_lm --config cfg.yaml [--run_root runs]
"""

from __future__ import annotations

import argparse


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
                    help="not ported: raises NotImplementedError above 1")
    ap.add_argument("--tensor_parallel", type=int, default=None,
                    help="not ported: raises NotImplementedError above 1")
    ap.add_argument("--pipeline_stages", type=int, default=None,
                    help="not ported: raises NotImplementedError above 1")
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
    for flag in ("mesh_devices", "tensor_parallel", "pipeline_stages"):
        value = getattr(args, flag)
        if value is not None and value > 1:
            raise NotImplementedError(f"--{flag} {value} is not ported")

    meta = run_training(
        cfg,
        config_path=args.config,
        resume=args.resume,
        transfer_from=cfg.get("transfer_from"),
        run_root=args.run_root,
        device=args.device,
    )
    # a preempted run saved its checkpoint; exit with the conventional
    # 128+signum so supervisors see the termination cause
    if meta and meta.get("preempted_by_signal"):
        return 128 + int(meta["preempted_by_signal"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
