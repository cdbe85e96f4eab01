"""Does a trained run use long-range context? (twin of
``scripts/diagnose_context_learning.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.diagnose_context_learning <run_id> --npz split.npz \\
        [--windows 1,2,4,8] [--position_buckets 0,8,32,128] [--batch_size 32] \\
        [--max_batches 8] [--out context_diagnostics.json] [--run_root runs] [--device cpu]

The mean NLL of the non-PAD targets by position in the window, bucketed by
``np.digitize`` over ``--position_buckets``, over the first
``max_batches`` batches; then ``evals/perplexity.py::context_ablation``
over the whole split at each of ``--windows`` and the full context (the
flash forward on the card, one a batch and window), with each window's
``delta_vs_full`` and ``context_gain_w1_minus_full``. Writes ``--out``
(default ``<run>/scores/context_diagnostics.json``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--npz", required=True)
    ap.add_argument("--windows", default="1,2,4,8")
    ap.add_argument("--position_buckets", default="0,8,32,128")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--max_batches", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.evals.perplexity import context_ablation
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.models.codon_gpt import forward
    from genomics_lm_torch.utils.cli import resolve_run_dir
    from genomics_lm_torch.utils.device import module_device

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, _, _ = load_codon_model(run_dir, device=args.device)
    cfg = cfg.replace(dropout=0.0)
    device = module_device(model)

    @torch.no_grad()
    def token_nll(x, y):
        x = torch.from_numpy(np.asarray(x)).long().to(device)
        y = torch.from_numpy(np.asarray(y)).long().to(device)
        logits, _ = forward(model, cfg, x)
        logits = logits.float()
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y[..., None])[..., 0]
        return nll.cpu().numpy(), (y != 0).cpu().numpy()

    ds = PackedDataset(args.npz)
    edges = [int(e) for e in args.position_buckets.split(",")]
    sums = np.zeros(len(edges))
    counts = np.zeros(len(edges))
    for start in range(0, min(len(ds), args.max_batches * args.batch_size), args.batch_size):
        x, y = ds.fetch_batch(list(range(start, min(start + args.batch_size, len(ds)))))
        nll, valid = token_nll(x, y)
        positions = np.broadcast_to(np.arange(x.shape[1]), x.shape)
        bucket = np.digitize(positions, edges) - 1
        for b in range(len(edges)):
            mask = (bucket == b) & valid
            sums[b] += nll[mask].sum()
            counts[b] += mask.sum()
    position_nll = {
        f">={edges[b]}": (float(sums[b] / counts[b]) if counts[b] else None)
        for b in range(len(edges))
    }

    windows = [int(w) for w in args.windows.split(",")] + [None]
    ablation = context_ablation(model, cfg, args.npz, windows=tuple(windows),
                                batch_size=args.batch_size)
    full_nll = ablation["full"]["nll"]
    report = {
        "position_nll": position_nll,
        "window_ablation": {
            k: {"nll": v["nll"], "delta_vs_full": v["nll"] - full_nll}
            for k, v in ablation.items()
        },
        "context_gain_w1_minus_full": ablation["1"]["nll"] - full_nll,
    }
    out = Path(args.out) if args.out else run_dir / "scores" / "context_diagnostics.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
