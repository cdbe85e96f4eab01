"""Evaluate a multi-task protein-critic checkpoint on a JSONL split (twin of
``scripts/eval_multi_task_critic.py``, the same flags plus ``--device``):

    python -m genomics_lm_torch.protein.eval_multi_task_critic --ckpt best_critic.npz \
        --jsonl val.jsonl [--batch_size 16] [--out outputs/critic/multitask_eval.json] \
        [--device cpu]

Per-task accuracy over the classification heads and MAE over a regression
head, from batches of the split in file order, padded to their longest row.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="multitask critic checkpoint")
    ap.add_argument("--jsonl", required=True, help="eval split (pfam_id/ec_id/...)")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--out", default="outputs/critic/multitask_eval.json")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from genomics_lm_torch.models.protein import multitask_forward
    from genomics_lm_torch.protein._cli import critic_from_checkpoint
    from genomics_lm_torch.protein.dataset import MultiTaskProteinDataset
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer

    tokenizer = ProteinTokenizer()
    model, cfg, payload = critic_from_checkpoint(args.ckpt, args.device, pooling="attention",
                                                 bidirectional=True)
    device = model.backbone.token_embedding.device
    head_names = sorted(payload["model"]["heads"].keys())

    ds = MultiTaskProteinDataset(args.jsonl, tokenizer, max_length=cfg.block_size)

    stats = {name: {"correct": 0, "count": 0, "abs_err": 0.0} for name in head_names}
    for start in range(0, len(ds), args.batch_size):
        idx = list(range(start, min(start + args.batch_size, len(ds))))
        batch = ds.batch(idx)
        with torch.no_grad():
            out = multitask_forward(model, cfg,
                                    torch.as_tensor(batch["input_ids"], device=device),
                                    torch.as_tensor(batch["attention_mask"], device=device))
        for name in head_names:
            if name not in batch:
                continue
            logits = out[name].cpu().numpy()
            labels = np.asarray(batch[name])
            if logits.shape[-1] == 1:  # regression head
                valid = ~np.isnan(labels)
                stats[name]["abs_err"] += float(
                    np.abs(logits[:, 0][valid] - labels[valid]).sum()
                )
                stats[name]["count"] += int(valid.sum())
            else:
                valid = labels >= 0
                pred = logits.argmax(-1)
                stats[name]["correct"] += int((pred[valid] == labels[valid]).sum())
                stats[name]["count"] += int(valid.sum())

    report = {"samples": len(ds), "tasks": {}}
    for name, s in stats.items():
        head_dim = int(np.asarray(payload["model"]["heads"][name]["w"]).shape[-1])
        if s["count"] == 0:
            report["tasks"][name] = {"labeled": 0}
        elif head_dim == 1:
            report["tasks"][name] = {"labeled": s["count"],
                                     "mae": s["abs_err"] / s["count"]}
        else:
            report["tasks"][name] = {"labeled": s["count"],
                                     "accuracy": s["correct"] / s["count"]}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
