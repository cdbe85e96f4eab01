"""Generative design loop: ReD → critic → likelihood → fold → report (twin
of ``scripts/generative_design_loop.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.generation.generative_design_loop <run_id> \
        [--critic_ckpt best_critic.npz [--ebm_ckpt best_ebm.npz]] \
        [--target_task stability] [--target_class C] \
        [--n_candidates 8] [--prefix ATG] [--target_codons 24] [--hard_cap 72] \
        [--budget 4000] [--esm_fold_top 2 --fold_backend mock] [--out_dir dir] \
        [--device cpu]

1. batch ReD generation (Reset-and-Discard until a terminal stop) from the
   prefix under a global token budget, on the decoder's device (the decode
   kernel on the card),
2. with ``--critic_ckpt``, the multi-task protein critic on the same device
   scores each candidate's protein (``protein/critic_scoring.py``):
   stability probability and prediction, family/function top-1, confidence
   and entropy, and ``critic_score`` (the target task's log-probability, or
   the negative EBM energy with ``--ebm_ckpt``),
3. each candidate's mean log-probability and perplexity under the model,
   its codon entropy and GC,
4. library diversity: pairwise identity, k-mer diversity, length and GC,
5. opt-in folding of the top candidates by stability (by likelihood without
   a critic; ``--esm_fold_top``; ``--fold_backend mock`` is deterministic
   and offline, ``api`` posts to the public ESMFold endpoint),
6. candidates.csv, summary.json and report.md (with its critic section).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from collections import Counter
from pathlib import Path


def shannon_entropy(codons: list[str]) -> float:
    """Codon-usage entropy (bits) of one candidate."""
    if not codons:
        return 0.0
    counts = Counter(codons)
    total = sum(counts.values())
    return -sum(
        (c / total) * math.log2(c / total) for c in counts.values()
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("run_id")
    ap.add_argument("--critic_ckpt", default=None)
    ap.add_argument("--ebm_ckpt", default=None)
    ap.add_argument("--n_candidates", type=int, default=8)
    ap.add_argument("--prefix", default="ATG")
    ap.add_argument("--target_codons", type=int, default=24)
    ap.add_argument("--hard_cap", type=int, default=72)
    ap.add_argument("--budget", type=int, default=4000)
    ap.add_argument("--target_task", default="stability")
    ap.add_argument("--target_class", type=int, default=None)
    ap.add_argument("--esm_fold_top", type=int, default=0,
                    help="fold the top-N candidates (0 disables)")
    ap.add_argument("--fold_backend", choices=("api", "mock"), default="api",
                    help="mock = deterministic offline fold (tests/CI)")
    ap.add_argument("--fold_timeout", type=float, default=45.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.diversity import (
        gc_content,
        kmer_diversity,
        pairwise_identity,
    )
    from genomics_lm_torch.evals.playground import (
        dna_to_context_ids,
        make_decoder,
        score_sequence,
        translate_codons_to_aa,
    )
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.utils.cli import resolve_run_dir

    wall0 = time.perf_counter()
    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    rng = np.random.default_rng(args.seed)

    # --- critic (optional) ---------------------------------------------
    score_fn = bundle = None
    if args.critic_ckpt:
        from genomics_lm_torch.protein.critic_scoring import load_score_fn

        score_fn, bundle = load_score_fn(
            args.critic_ckpt,
            ebm_ckpt=args.ebm_ckpt,
            target_task=args.target_task,
            target_class_idx=args.target_class,
            device=decoder.device,
        )

    # --- 1. ReD generation ---------------------------------------------
    ctx = dna_to_context_ids(args.prefix, stoi)
    contexts = [list(ctx) for _ in range(args.n_candidates)]
    solved, remaining, spent = gen.batch_red_sampler(
        decoder, contexts, stoi, itos,
        target_codons=args.target_codons, hard_cap=args.hard_cap,
        global_token_budget=args.budget, rng=rng,
    )

    # --- 2-3. per-candidate scoring ------------------------------------
    rows = []
    for idx, (ids, info) in sorted(solved.items()):
        codons = [itos[t] for t in ids[len(ctx):]
                  if len(itos[t]) == 3 and "<" not in itos[t]]
        aa = translate_codons_to_aa(codons[:-1] if codons else [])
        likelihood = score_sequence(decoder, ids)
        row = {
            "candidate": idx,
            "dna": "".join(codons),
            "protein": aa,
            "codons": len(codons),
            "round": info.get("round", 1),
            "mean_logprob": likelihood["mean_logprob"],
            "perplexity": float(np.exp(-likelihood["mean_logprob"])),
            "codon_entropy_bits": shannon_entropy(codons),
            "gc": gc_content([codons])[0],
        }
        if bundle is not None and aa:
            from genomics_lm_torch.protein.critic_scoring import score_candidate_tasks

            task_scores = score_candidate_tasks(bundle, aa)
            for key in ("stability_prob", "stability_pred",
                        "family_top1", "family_top1_conf", "family_entropy",
                        "function_top1", "function_top1_conf",
                        "function_entropy"):
                if key in task_scores:
                    row[key] = task_scores[key]
            row["critic_score"] = float(score_fn([aa])[0])
        rows.append(row)

    # --- 4. library diversity ------------------------------------------
    aa_seqs = [r["protein"] for r in rows if r["protein"]]
    lengths = [len(a) for a in aa_seqs]
    gcs = [r["gc"] for r in rows]
    summary = {
        "solved": len(solved),
        "unsolved": len(remaining),
        "requested": int(args.n_candidates),
        "termination_rate": len(solved) / max(1, args.n_candidates),
        "tokens_spent": spent,
        "elapsed_sec": round(time.perf_counter() - wall0, 2),
        "pairwise_identity": pairwise_identity(aa_seqs, seed=args.seed),
        "kmer_diversity": kmer_diversity(aa_seqs) if aa_seqs else 0.0,
        "mean_aa_len": float(np.mean(lengths)) if lengths else 0.0,
        "std_aa_len": float(np.std(lengths)) if lengths else 0.0,
        "mean_gc": float(np.mean(gcs)) if gcs else 0.0,
        "std_gc": float(np.std(gcs)) if gcs else 0.0,
    }
    if any("stability_prob" in r for r in rows):
        stabs = [r["stability_prob"] for r in rows if "stability_prob" in r]
        summary["mean_stability_prob"] = float(np.mean(stabs))
        summary["frac_stable_p70"] = float(np.mean([s > 0.7 for s in stabs]))

    out_dir = Path(args.out_dir) if args.out_dir else run_dir / "scores" / "design_loop"
    out_dir.mkdir(parents=True, exist_ok=True)

    # --- 5. opt-in folding ---------------------------------------------
    folded: dict = {}
    if args.esm_fold_top > 0 and rows:
        from genomics_lm_torch.evals.folding import fold_sequences

        rank_key = (
            "stability_prob" if any("stability_prob" in r for r in rows)
            else "mean_logprob"
        )
        ranked = sorted(
            [r for r in rows if r["protein"]],
            key=lambda r: r.get(rank_key, float("-inf")), reverse=True,
        )[: args.esm_fold_top]
        folded = fold_sequences(
            [(f"candidate_{r['candidate']}", r["protein"]) for r in ranked],
            backend=args.fold_backend,
            out_dir=out_dir / "folds",
            timeout=args.fold_timeout,
        )
        for r in rows:
            stats = folded.get(f"candidate_{r['candidate']}")
            if stats:
                r["esmfold_plddt"] = stats["plddt_mean"]
                r["esmfold_plddt_min"] = stats["plddt_min"]
                r["esmfold_plddt_max"] = stats["plddt_max"]
                r["pdb"] = stats.get("pdb")
        if folded:
            plddts = [s["plddt_mean"] for s in folded.values()]
            summary["folded"] = len(folded)
            summary["fold_backend"] = args.fold_backend
            summary["mean_plddt"] = float(np.mean(plddts))
    for r in rows:
        r.setdefault("esmfold_plddt", None)

    # --- 6. outputs ----------------------------------------------------
    from genomics_lm_torch.evals.gen_prefix import write_csv

    write_csv(out_dir / "candidates.csv", rows)
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")

    md = [
        "# Generative Design Loop — Report", "",
        f"**Requested:** {args.n_candidates}  |  **Solved:** {summary['solved']} "
        f"({summary['termination_rate'] * 100:.1f}%)  |  "
        f"**Tokens spent:** {summary['tokens_spent']}  |  "
        f"**Elapsed:** {summary['elapsed_sec']}s", "",
        "## 1. Termination (ReD sampling)", "",
        "| Metric | Value |", "|---|---|",
        f"| Sequences requested | {args.n_candidates} |",
        f"| Properly terminated | {summary['solved']} |",
        f"| Token budget spent | {summary['tokens_spent']} |", "",
        "## 2. Sequence statistics", "",
        "| Metric | Value |", "|---|---|",
        f"| Mean AA length | {summary['mean_aa_len']:.1f} ± {summary['std_aa_len']:.1f} |",
        f"| Mean GC content | {summary['mean_gc'] * 100:.1f}% ± {summary['std_gc'] * 100:.1f}% |",
        f"| Pairwise identity | {summary['pairwise_identity']:.3f} |",
        f"| k-mer diversity | {summary['kmer_diversity']:.4f} |", "",
    ]
    if "mean_stability_prob" in summary:
        md += [
            "## 3. Critic scores", "",
            "| Metric | Value |", "|---|---|",
            f"| Mean stability probability | {summary['mean_stability_prob']:.3f} |",
            f"| P(stable) > 0.7 | {summary['frac_stable_p70'] * 100:.1f}% |", "",
        ]
    if folded:
        md += [
            "## 4. ESMFold structure confidence", "",
            f"Backend: `{summary['fold_backend']}` — top {len(folded)} candidates", "",
            "| candidate | pLDDT mean | min | max |", "|---|---|---|---|",
        ]
        for name, stats in sorted(folded.items()):
            md.append(
                f"| {name} | {stats['plddt_mean']:.1f} | "
                f"{stats['plddt_min']:.1f} | {stats['plddt_max']:.1f} |"
            )
        md.append("")
    md += ["## Candidates", "",
           "| candidate | codons | mean logP | critic | pLDDT |",
           "|---|---|---|---|---|"]
    for r in rows:
        critic = (f"{r['critic_score']:.3f}" if r.get("critic_score") is not None
                  else "-")
        plddt = (f"{r['esmfold_plddt']:.1f}" if r.get("esmfold_plddt") is not None
                 else "-")
        md.append(f"| {r['candidate']} | {r['codons']} | "
                  f"{r['mean_logprob']:.3f} | {critic} | {plddt} |")
    (out_dir / "report.md").write_text("\n".join(md) + "\n")
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
