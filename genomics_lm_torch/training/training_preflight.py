"""End-to-end preflight: synthesize a dataset, train, check the artifacts,
resume (twin of ``scripts/training_preflight.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.training.training_preflight [--work_dir DIR] \\
        [--epochs 1] [--device cuda:0]

Writes a manifest-less packed fixture (48 train and 12 validation windows
of 32, seed 0) and ``itos.txt`` into the work directory (a fresh temporary
one by default), trains 1L2H d16 for ``--epochs`` with the port's trainer
on ``--device`` (default: the CUDA card), checks ``last.npz``, ``best.npz``,
``curves.csv`` and ``meta.json``, then resumes from ``last.npz`` for one
epoch more. Prints ``PREFLIGHT_RESULT: {json}``; exit 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path


def run_preflight(work_dir: Path | None = None, *, epochs: int = 1, device=None) -> dict:
    import numpy as np

    from genomics_lm_torch.tokenizers.codon import write_itos
    from genomics_lm_torch.training.loop import run_training

    work = Path(work_dir) if work_dir else Path(tempfile.mkdtemp(prefix="preflight_"))
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for name, n in (("train", 48), ("val", 12)):
        X = rng.integers(4, 68, (n, 32)).astype(np.int32)
        X[:, 0] = 1
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 2
        np.savez(work / f"{name}.npz", X=X, Y=Y)
    write_itos(work / "itos.txt")

    cfg = dict(
        train_npz=str(work / "train.npz"), val_npz=str(work / "val.npz"),
        block_size=32, n_layer=1, n_head=2, n_embd=16, dropout=0.0,
        batch_size=8, grad_accum_steps=2, lr=1e-3, warmup_steps=1,
        epochs=epochs, seed=0, run_id="preflight", early_stop_patience=0,
    )
    meta = run_training(cfg, run_root=str(work / "runs"), device=device)
    checks = {"initial_train": meta["status"] == "completed"}
    run_dir = work / "runs" / "preflight"
    for artifact in ("checkpoints/last.npz", "checkpoints/best.npz",
                     "scores/curves.csv", "checkpoints/meta.json"):
        checks[artifact] = (run_dir / artifact).exists()

    resume_cfg = dict(cfg, epochs=epochs + 1)
    meta2 = run_training(
        resume_cfg,
        resume=str(run_dir / "checkpoints" / "last.npz"),
        run_root=str(work / "runs"),
        device=device,
    )
    checks["resume"] = meta2["status"] == "completed"
    checks["resumed_epoch"] = meta2.get("last_epoch") == epochs + 1
    return {"work_dir": str(work), "checks": checks,
            "passed": all(checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    report = run_preflight(Path(args.work_dir) if args.work_dir else None,
                           epochs=args.epochs, device=args.device)
    print("PREFLIGHT_RESULT: " + json.dumps(report))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
