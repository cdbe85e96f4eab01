"""Side-by-side checkpoint comparison (twin of
``scripts/compare_checkpoints.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.compare_checkpoints a.npz b.npz ... \\
        --npz val.npz [--batch_size 32] [--device cuda:0]

Each checkpoint is scored at dropout 0 by ``evaluate_perplexity`` on
``--device`` (default: the CUDA card); prints the rows
``{checkpoint, epoch, spec, nll, perplexity}`` sorted by NLL as JSON, then
the best one.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoints", nargs="+")
    ap.add_argument("--npz", required=True)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.eval_epoch_sweep import score_checkpoint
    from genomics_lm_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rows = []
    for path in args.checkpoints:
        out, payload, cfg = score_checkpoint(path, args.npz, batch_size=args.batch_size,
                                             device=device)
        rows.append({
            "checkpoint": path,
            "epoch": payload.get("epoch"),
            "spec": f"{cfg.n_layer}L{cfg.n_head}H d{cfg.n_embd}",
            "nll": out["nll"],
            "perplexity": out["perplexity"],
        })
    rows.sort(key=lambda r: r["nll"])
    print(json.dumps(rows, indent=2))
    print(f"[compare] best: {rows[0]['checkpoint']} (ppl {rows[0]['perplexity']:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
