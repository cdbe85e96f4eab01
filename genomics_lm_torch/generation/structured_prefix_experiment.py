"""Structured-prefix generation experiment (twin of
``scripts/structured_prefix_experiment.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.generation.structured_prefix_experiment <run_id> \\
        [--critic_ckpt critic.npz] [--n_per_prefix 4] [--target_codons 32] \\
        [--hard_cap 96] [--seed 0] [--out_dir outputs/structured_prefix] [--device cpu]

ReD continuations of three DNA prefixes that encode the N-termini of
structured bacterial folds, ``--n_per_prefix`` each, every draw from one
generator seeded with ``--seed``, on the run's decoder (the card unless
``--device`` names another). Each candidate's DNA, protein, GC fraction and
terminal stop are kept, and with ``--critic_ckpt`` its critic score (the
critic attention-pooled unless its checkpoint names a pooling). Writes
``structured_prefix_candidates.csv`` and ``structured_prefix_report.md``
under ``--out_dir``; ESMFold needs network access and is not called.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

# DNA prefixes encoding the N-termini of well-structured bacterial folds
STRUCTURED_PREFIXES = {
    "tim_barrel_like": "ATGAAAGCACTGGTTCTGGGC",
    "rossmann_like": "ATGAAAATTGGTATCGACGGT",
    "beta_barrel_like": "ATGAAAAAACTGACCCTGGCA",
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--critic_ckpt", default=None)
    ap.add_argument("--n_per_prefix", type=int, default=4)
    ap.add_argument("--target_codons", type=int, default=32)
    ap.add_argument("--hard_cap", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default="outputs/structured_prefix")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.playground import (
        dna_to_context_ids,
        make_decoder,
        translate_codons_to_aa,
    )
    from genomics_lm_torch.evals.termination_motifs import gc_fraction
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.generation.run_ablation_sweep import codons_of
    from genomics_lm_torch.protein.critic_scoring import load_critic, make_score_fn
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    rng = np.random.default_rng(args.seed)

    score_fn = None
    if args.critic_ckpt:
        critic, critic_cfg, tokenizer, _ = load_critic(
            args.critic_ckpt, default_pooling="attention", device=decoder.device)
        score_fn = make_score_fn(critic, critic_cfg, tokenizer)

    rows = []
    for name, prefix in STRUCTURED_PREFIXES.items():
        ctx = dna_to_context_ids(prefix, stoi)
        for sample in range(args.n_per_prefix):
            out_ids, info = gen.generate_cds_red(
                decoder, ctx, stoi, itos,
                target_codons=args.target_codons, hard_cap=args.hard_cap,
                rng=rng,
            )
            codons = codons_of(out_ids, len(ctx), itos)
            dna = prefix + "".join(codons)
            protein = translate_codons_to_aa(
                [prefix[i : i + 3] for i in range(0, len(prefix), 3)] + codons
            ).rstrip("_*")
            row = {
                "prefix": name,
                "sample": sample,
                "dna": dna,
                "protein": protein,
                "protein_len": len(protein),
                "gc": round(gc_fraction(dna), 4),
                "had_terminal_stop": bool(info["had_terminal_stop"]),
            }
            if score_fn and protein:
                row["critic_score"] = float(np.asarray(score_fn([protein]))[0])
            rows.append(row)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with (out_dir / "structured_prefix_candidates.csv").open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()) if rows else ["prefix"])
        writer.writeheader()
        writer.writerows(rows)

    md = ["# Structured-prefix generation", ""]
    for name in STRUCTURED_PREFIXES:
        subset = [r for r in rows if r["prefix"] == name]
        stop_rate = sum(r["had_terminal_stop"] for r in subset) / max(len(subset), 1)
        md.append(f"## {name}")
        md.append(f"- samples: {len(subset)}")
        md.append(f"- terminal stop rate: {stop_rate:.2f}")
        if subset and "critic_score" in subset[0]:
            best = max(subset, key=lambda r: r.get("critic_score") or -1e9)
            md.append(f"- best critic score: {best['critic_score']:.4f} "
                      f"(sample {best['sample']})")
        md.append("")
    md.append("_ESMFold submission requires network access — see "
              "scripts/submit_esmfold_from_csv.py._")
    (out_dir / "structured_prefix_report.md").write_text("\n".join(md) + "\n")

    print(json.dumps({"candidates": len(rows), "out_dir": str(out_dir)}, indent=2))
    return 0


__all__ = ["STRUCTURED_PREFIXES", "main", "parser"]


if __name__ == "__main__":
    raise SystemExit(main())
