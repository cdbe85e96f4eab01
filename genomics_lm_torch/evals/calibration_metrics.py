"""Next-token calibration of a trained run (twin of
``scripts/calibration_metrics.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.calibration_metrics <run_id> --npz split.npz \\
        [--n_bins 10] [--max_batches 16] [--batch_size 32] [--out calibration.json] \\
        [--run_root runs] [--device cpu]

The top-1 confidence (softmax in float32) and hit of every non-PAD target
in the first ``max_batches`` batches of a packed split (one ``forward`` a
batch: the flash forward on the card), then the expected calibration
error over ``n_bins`` equal bins (the last closed, empty bins skipped),
the top-1 Brier score and the reliability table. Writes ``--out`` (default
``<run>/scores/calibration.json``) and prints the headline numbers.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def calibration_report(model, cfg, dataset, n_bins: int = 10, max_batches: int = 16,
                       batch_size: int = 32) -> dict:
    """The script's report (``tokens``, ``ece``, ``brier_top1``,
    ``top1_accuracy``, ``reliability``) of ``model`` on a packed split
    (a path or a ``PackedDataset``), on the model's device."""
    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.models.codon_gpt import forward
    from genomics_lm_torch.utils.device import module_device

    device = module_device(model)

    @torch.no_grad()
    def top1(x, y):
        x = torch.from_numpy(np.asarray(x)).long().to(device)
        y = torch.from_numpy(np.asarray(y)).long().to(device)
        logits, _ = forward(model, cfg, x)
        probs = torch.softmax(logits.float(), dim=-1)
        conf, pred = probs.max(dim=-1)
        return conf.cpu().numpy(), (pred == y).cpu().numpy(), (y != 0).cpu().numpy()

    ds = dataset if isinstance(dataset, PackedDataset) else PackedDataset(dataset)
    confs, hits = [], []
    for start in range(0, min(len(ds), max_batches * batch_size), batch_size):
        x, y = ds.fetch_batch(list(range(start, min(start + batch_size, len(ds)))))
        c, h, v = top1(x, y)
        mask = v.reshape(-1)
        confs.append(c.reshape(-1)[mask])
        hits.append(h.reshape(-1)[mask])
    conf = np.concatenate(confs)
    hit = np.concatenate(hits).astype(np.float64)

    edges = np.linspace(0, 1, n_bins + 1)
    table = []
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = (conf >= lo) & (conf < hi if hi < 1 else conf <= hi)
        if not mask.any():
            continue
        acc = float(hit[mask].mean())
        avg_conf = float(conf[mask].mean())
        frac = float(mask.mean())
        ece += frac * abs(acc - avg_conf)
        table.append({"bin": f"{lo:.1f}-{hi:.1f}", "fraction": frac,
                      "confidence": avg_conf, "accuracy": acc})
    brier = float(((conf - hit) ** 2).mean())
    return {"tokens": int(conf.size), "ece": ece, "brier_top1": brier,
            "top1_accuracy": float(hit.mean()), "reliability": table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--npz", required=True)
    ap.add_argument("--n_bins", type=int, default=10)
    ap.add_argument("--max_batches", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, _, _ = load_codon_model(run_dir, device=args.device)
    report = calibration_report(model, cfg.replace(dropout=0.0), args.npz, args.n_bins,
                                args.max_batches, args.batch_size)
    out = Path(args.out) if args.out else run_dir / "scores" / "calibration.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps({k: report[k] for k in ("tokens", "ece", "brier_top1",
                                             "top1_accuracy")}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
