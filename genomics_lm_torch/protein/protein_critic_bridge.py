"""Translate generated DNA and filter by protein-critic viability (twin of
``scripts/protein_critic_bridge.py``, the same flags plus ``--device``):

    python -m genomics_lm_torch.protein.protein_critic_bridge --dna_csv designs.csv \
        --critic_ckpt best_critic.npz --out bridged.csv [--target_task stability] \
        [--target_class C] [--min_score S] [--device cpu]

Each candidate's DNA is translated (``data/leakage.py::translate_cds``);
those without an internal stop are scored in one critic batch on the device
(``critic_scoring.make_score_fn``), and pass when their score reaches
``--min_score``.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dna_csv", required=True, help="CSV with id,dna columns")
    ap.add_argument("--critic_ckpt", required=True)
    ap.add_argument("--target_task", default="stability")
    ap.add_argument("--target_class", type=int, default=None)
    ap.add_argument("--min_score", type=float, default=None,
                    help="keep candidates with critic log-prob >= this")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.data.leakage import translate_cds
    from genomics_lm_torch.protein._cli import critic_from_checkpoint
    from genomics_lm_torch.protein.critic_scoring import make_score_fn
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer

    tokenizer = ProteinTokenizer()
    model, cfg, _ = critic_from_checkpoint(args.critic_ckpt, args.device, pooling="attention")
    score_fn = make_score_fn(model, cfg, tokenizer,
                             target_task=args.target_task,
                             target_class_idx=args.target_class)

    stop_codons = {"TAA", "TAG", "TGA"}
    rows = []
    with open(args.dna_csv) as f:
        for i, record in enumerate(csv.DictReader(f)):
            dna = record.get("dna") or record.get("sequence")
            if not dna:
                continue
            dna_u = dna.upper().replace("U", "T")
            codons = [dna_u[j : j + 3]
                      for j in range(0, (len(dna_u) // 3) * 3, 3)]
            internal_stop = any(c in stop_codons for c in codons[:-1])
            try:
                protein = translate_cds(dna).rstrip("*_X")
                translation_ok = bool(protein) and not internal_stop
            except Exception:
                protein, translation_ok = "", False
            rows.append({
                "id": record.get("id") or f"cand{i}",
                "dna": dna,
                "protein": protein,
                "translation_ok": translation_ok,
            })

    viable = [r for r in rows if r["translation_ok"]]
    if viable:
        scores = np.asarray(score_fn([r["protein"] for r in viable]))
        for r, s in zip(viable, scores):
            r["critic_score"] = float(s)
    for r in rows:
        r.setdefault("critic_score", None)
        r["passed"] = bool(
            r["translation_ok"]
            and (args.min_score is None or
                 (r["critic_score"] is not None
                  and r["critic_score"] >= args.min_score))
        )

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["id", "dna", "protein",
                                               "translation_ok",
                                               "critic_score", "passed"])
        writer.writeheader()
        writer.writerows(rows)
    summary = {
        "candidates": len(rows),
        "translation_ok": sum(r["translation_ok"] for r in rows),
        "passed": sum(r["passed"] for r in rows),
        "mean_critic_score": (
            float(np.mean([r["critic_score"] for r in viable])) if viable else None
        ),
        "out": str(out),
    }
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
