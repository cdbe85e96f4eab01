"""Guidance-component ablation (twin of ``scripts/run_guidance_ablation.py``,
the same flags plus ``--device``).

    python -m genomics_lm_torch.generation.run_guidance_ablation <run_id> \\
        [--critic_ckpt critic.npz] [--n_samples 12] [--target_codons 24] \\
        [--hard_cap 72] [--seed 0] [--out report.json] [--device cpu]

Unguided, termination-biased and (for a run trained with offset targets)
offset-prior constrained generation from ``ATG`` under the same budget,
each variant's ``--n_samples`` draws from one generator seeded with
``--seed``, on the run's decoder (the card unless ``--device`` names
another); with ``--critic_ckpt`` also critic-guided generation (the critic
mean-pooled unless its checkpoint names a pooling, as the script reads it).
Each variant reports its terminal-stop rate and mean codons and tokens.
Writes ``<run>/scores/guidance_ablation.json`` (or ``--out``) and prints it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--critic_ckpt", default=None)
    ap.add_argument("--n_samples", type=int, default=12)
    ap.add_argument("--target_codons", type=int, default=24)
    ap.add_argument("--hard_cap", type=int, default=72)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def summarize(infos) -> dict:
    import numpy as np

    return {
        "terminal_stop_rate": float(np.mean([i["had_terminal_stop"] for i in infos])),
        "mean_codons": float(np.mean([i["generated_codons"] for i in infos])),
        "mean_tokens": float(np.mean([i["generated_tokens"] for i in infos])),
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.playground import dna_to_context_ids, make_decoder
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.protein.critic_scoring import load_critic, make_score_fn
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    ctx = dna_to_context_ids("ATG", stoi)

    variants = {
        "unguided": {},
        "termination_bias": {
            "termination_bias_enabled": True,
            "termination_stop_bias": 2.0,
            "termination_bias_window": 8,
        },
    }
    if decoder.cfg.multi_offset_targets:
        variants["offset_priors"] = {
            "multi_offset_prior_enabled": True,
            "multi_offset_prior_weights": {o: 0.25 for o in decoder.cfg.multi_offset_targets},
        }

    report = {}
    for name, kwargs in variants.items():
        rng = np.random.default_rng(args.seed)
        report[name] = summarize([
            gen.generate_cds_constrained(
                decoder, ctx, stoi, itos,
                target_codons=args.target_codons, hard_cap=args.hard_cap,
                require_terminal_stop=True, rng=rng, **kwargs,
            )[1]
            for _ in range(args.n_samples)
        ])

    if args.critic_ckpt:
        critic, critic_cfg, tokenizer, _ = load_critic(args.critic_ckpt, default_pooling="mean",
                                                       device=decoder.device)
        score_fn = make_score_fn(critic, critic_cfg, tokenizer)
        rng = np.random.default_rng(args.seed)
        report["critic_guided"] = summarize([
            gen.generate_cds_critic_guided(
                decoder, score_fn, ctx, stoi, itos,
                target_codons=args.target_codons, hard_cap=args.hard_cap,
                require_terminal_stop=True, rng=rng,
            )[1]
            for _ in range(args.n_samples)
        ])

    out = Path(args.out) if args.out else run_dir / "scores" / "guidance_ablation.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


__all__ = ["main", "parser", "summarize"]


if __name__ == "__main__":
    raise SystemExit(main())
