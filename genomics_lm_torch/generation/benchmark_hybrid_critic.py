"""Critic-guided DNA-to-protein generation against its guidance strength
(twin of ``scripts/benchmark_hybrid_critic.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.generation.benchmark_hybrid_critic <run_id> \\
        --critic_ckpt critic.npz [--ebm_ckpt ebm.npz] [--alphas 0,0.5,1.0] \\
        [--n_samples 4] [--target_codons 16] [--hard_cap 48] \\
        [--target_task stability] [--seed 0] \\
        [--out outputs/benchmarks/hybrid_critic.json] [--device cpu]

For each guidance strength alpha, ``--n_samples`` generations from ``ATG``
(critic-guided above 0, plain constrained at 0), each alpha's draws from one
generator seeded with ``--seed``, on the run's decoder (the card unless
``--device`` names another). The critic (attention-pooled unless its
checkpoint names a pooling) scores each protein under ``--target_task``;
with ``--ebm_ckpt`` each protein's latent also gets its EBM energy. Each
alpha reports the mean critic score and energy, the ORF-valid rate (one stop,
at the end), the mean codons, wall seconds and samples per second. Writes
``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

STOP_CODONS = {"TAA", "TAG", "TGA"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--critic_ckpt", required=True)
    ap.add_argument("--ebm_ckpt", default=None)
    ap.add_argument("--alphas", default="0,0.5,1.0")
    ap.add_argument("--n_samples", type=int, default=4)
    ap.add_argument("--target_codons", type=int, default=16)
    ap.add_argument("--hard_cap", type=int, default=48)
    ap.add_argument("--target_task", default="stability")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="outputs/benchmarks/hybrid_critic.json")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    from genomics_lm_torch.evals.playground import (
        dna_to_context_ids,
        make_decoder,
        translate_codons_to_aa,
    )
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.generation.run_ablation_sweep import codons_of
    from genomics_lm_torch.models.protein import ebm_energy, extract_latent
    from genomics_lm_torch.protein.critic_scoring import load_critic, load_ebm, make_score_fn
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    critic, critic_cfg, tokenizer, _ = load_critic(
        args.critic_ckpt, default_pooling="attention", device=decoder.device)
    ebm = load_ebm(args.ebm_ckpt, decoder.device) if args.ebm_ckpt else None
    score_fn = make_score_fn(critic, critic_cfg, tokenizer, target_task=args.target_task,
                             ebm=ebm)

    @torch.no_grad()
    def energy(protein: str) -> float:
        ids = [tokenizer.bos_token_id] + tokenizer.encode_sequence(protein) + [
            tokenizer.eos_token_id]
        z = extract_latent(critic, critic_cfg,
                           torch.tensor([ids], dtype=torch.int32, device=decoder.device),
                           torch.ones((1, len(ids)), dtype=torch.int32, device=decoder.device))
        return float(ebm_energy(ebm, z)[0])

    ctx = dna_to_context_ids("ATG", stoi)
    results = []
    for alpha in (float(a) for a in args.alphas.split(",")):
        rng = np.random.default_rng(args.seed)
        scores, energies, orf_ok, lengths = [], [], [], []
        t0 = time.time()
        for _ in range(args.n_samples):
            if alpha > 0:
                out_ids, info = gen.generate_cds_critic_guided(
                    decoder, score_fn, ctx, stoi, itos,
                    target_codons=args.target_codons, hard_cap=args.hard_cap,
                    alpha=alpha, rng=rng,
                )
            else:
                out_ids, info = gen.generate_cds_constrained(
                    decoder, ctx, stoi, itos,
                    target_codons=args.target_codons, hard_cap=args.hard_cap,
                    rng=rng,
                )
            codons = codons_of(out_ids, len(ctx), itos)
            protein = translate_codons_to_aa(codons).rstrip("_*")
            lengths.append(len(codons))
            orf_ok.append(bool(codons) and codons[-1] in STOP_CODONS
                          and not any(c in STOP_CODONS for c in codons[:-1]))
            if protein:
                scores.append(float(np.asarray(score_fn([protein]))[0]))
                if ebm is not None:
                    energies.append(energy(protein))
        wall = time.time() - t0
        results.append({
            "alpha": alpha,
            "mean_critic_score": float(np.mean(scores)) if scores else None,
            "mean_ebm_energy": float(np.mean(energies)) if energies else None,
            "orf_valid_rate": float(np.mean(orf_ok)) if orf_ok else None,
            "mean_codons": float(np.mean(lengths)) if lengths else None,
            "wall_sec": round(wall, 3),
            "samples_per_sec": round(args.n_samples / wall, 3) if wall else None,
        })

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results, indent=2))
    return 0


__all__ = ["main", "parser"]


if __name__ == "__main__":
    raise SystemExit(main())
