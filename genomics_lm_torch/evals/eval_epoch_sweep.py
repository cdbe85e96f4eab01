"""Perplexity across a run's saved epoch checkpoints (twin of
``scripts/eval_epoch_sweep.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.eval_epoch_sweep <run_id> --npz val.npz \\
        [--batch_size 32] [--out sweep.json] [--run_root runs] [--device cuda:0]

Every ``checkpoints/epoch_*.npz`` (in epoch order; ``last.npz`` when the
run saved none) is loaded at dropout 0 and scored by
``evals/perplexity.py::evaluate_perplexity`` on ``--device`` (default: the
CUDA card), whose forward is the flash forward there. Writes the list of
``{checkpoint, epoch, nll, perplexity, tokens}`` to ``--out`` (default
``<run>/scores/epoch_sweep.json``). A run written by either trainer reads
the same.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path


def score_checkpoint(path, npz, *, batch_size: int, device) -> tuple:
    """``(evaluate_perplexity's result, the payload, the model config)`` for one
    checkpoint file, its model rebuilt from its own config at dropout 0."""
    from genomics_lm_torch.evals.perplexity import evaluate_perplexity
    from genomics_lm_torch.evals.playground import build_codon_model_from_cfg
    from genomics_lm_torch.training.checkpoints import load_checkpoint
    from genomics_lm_torch.utils.weights import params_from_jax

    payload = load_checkpoint(path)
    cfg = build_codon_model_from_cfg(payload["cfg"]).replace(dropout=0.0)
    model = params_from_jax(payload["model"], cfg, device).eval()
    return evaluate_perplexity(model, cfg, npz, batch_size=batch_size), payload, cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--npz", required=True)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.utils.cli import resolve_run_dir
    from genomics_lm_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    run_dir = resolve_run_dir(args.run_id, args.run_root)
    ckpt_dir = run_dir / "checkpoints"
    epoch_ckpts = sorted(
        ckpt_dir.glob("epoch_*.npz"),
        key=lambda p: int(re.search(r"epoch_(\d+)", p.name).group(1)),
    )
    if not epoch_ckpts:
        epoch_ckpts = [ckpt_dir / "last.npz"]

    results = []
    for path in epoch_ckpts:
        out, payload, _ = score_checkpoint(path, args.npz, batch_size=args.batch_size,
                                           device=device)
        results.append({"checkpoint": path.name, "epoch": payload.get("epoch"),
                        **{k: out[k] for k in ("nll", "perplexity", "tokens")}})
        print(f"[sweep] {path.name}: ppl {out['perplexity']:.3f}")

    out_path = Path(args.out) if args.out else run_dir / "scores" / "epoch_sweep.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
