"""Distance-to-stop accuracy of a run's termination head (twin of
``scripts/evaluate_termination_head.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.evaluate_termination_head <run_id> --npz split.npz \\
        [--batch_size 32] [--max_batches 8] [--out termination_head.json] \\
        [--run_root runs] [--device cpu]

The head's argmax (one ``forward`` a batch with its auxiliary outputs: the
flash forward on the card) against ``ops/losses.py::
termination_distance_bucket_labels`` with the codon vocabulary's
``STOP_IDS`` (as the script takes them, whatever the run's vocabulary),
over the labelled targets of the first ``max_batches`` batches: the
confusion matrix, per-class support and accuracy. A run without the head
prints the script's ``{"skipped": ...}`` and exits 0. Writes ``--out``
(default ``<run>/scores/termination_head.json``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--npz", required=True)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--max_batches", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.models.codon_gpt import forward
    from genomics_lm_torch.ops.losses import termination_distance_bucket_labels
    from genomics_lm_torch.tokenizers.codon import STOP_IDS
    from genomics_lm_torch.utils.cli import resolve_run_dir
    from genomics_lm_torch.utils.device import module_device

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, _, _ = load_codon_model(run_dir, device=args.device)
    cfg = cfg.replace(dropout=0.0)
    if not cfg.termination_aux:
        # absence of the optional head is a skip, not an eval failure
        print(json.dumps({"skipped": "checkpoint has no termination head "
                                     "(termination_aux=false)"}))
        return 0
    n_classes = cfg.termination_n_classes
    device = module_device(model)

    @torch.no_grad()
    def predict(x, y):
        x = torch.from_numpy(np.asarray(x)).long().to(device)
        y = torch.from_numpy(np.asarray(y)).long().to(device)
        _, _, aux = forward(model, cfg, x, return_aux=True)
        preds = torch.argmax(aux["termination_logits"], dim=-1)
        labels = termination_distance_bucket_labels(y, STOP_IDS)
        return preds.cpu().numpy(), labels.cpu().numpy()

    ds = PackedDataset(args.npz)
    confusion = np.zeros((n_classes, n_classes), np.int64)
    for start in range(0, min(len(ds), args.max_batches * args.batch_size), args.batch_size):
        x, y = ds.fetch_batch(list(range(start, min(start + args.batch_size, len(ds)))))
        preds, labels = predict(x, y)
        valid = labels != -100
        np.add.at(confusion, (labels[valid].astype(np.int64), preds[valid].astype(np.int64)), 1)
    total = confusion.sum()
    per_class = {
        str(c): {
            "support": int(confusion[c].sum()),
            "accuracy": float(confusion[c, c] / max(confusion[c].sum(), 1)),
        }
        for c in range(n_classes)
    }
    report = {
        "tokens": int(total),
        "accuracy": float(np.trace(confusion) / max(total, 1)),
        "per_class": per_class,
        "confusion": confusion.tolist(),
    }
    out = Path(args.out) if args.out else run_dir / "scores" / "termination_head.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps({k: report[k] for k in ("tokens", "accuracy")}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
