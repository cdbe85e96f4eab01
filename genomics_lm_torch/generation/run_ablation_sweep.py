"""Structured ablation sweep over decoding configurations (twin of
``scripts/run_ablation_sweep.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.generation.run_ablation_sweep <run_id> \\
        [--critic_ckpt critic.npz] [--n_samples 4] [--target_codons 16] \\
        [--hard_cap 48] [--stop_bias 2.0] [--alpha 0.5] [--seed 0] \\
        [--out report.json] [--device cpu]

Unguided and (with ``--critic_ckpt``) critic-guided generation crossed with
no stop bias and ReD's stop bias, from ``ATG`` on the run's decoder (the
card unless ``--device`` names another); each cell draws its
``--n_samples`` from one generator seeded with ``--seed``. A guided cell
runs the critic-guided generator whatever its bias, as the script does;
the critic is attention-pooled unless its checkpoint names a pooling. Each
cell reports its terminal-stop rate, mean codons, mean protein length and
wall seconds. Writes ``<run>/scores/ablation_sweep.json`` (or ``--out``)
and prints it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--critic_ckpt", default=None)
    ap.add_argument("--n_samples", type=int, default=4)
    ap.add_argument("--target_codons", type=int, default=16)
    ap.add_argument("--hard_cap", type=int, default=48)
    ap.add_argument("--stop_bias", type=float, default=2.0)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def codons_of(out_ids, n_ctx: int, itos) -> list[str]:
    """The generated codon tokens after the context (specials dropped)."""
    return [itos[t] for t in out_ids[n_ctx:] if len(itos[t]) == 3 and "<" not in itos[t]]


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.playground import (
        dna_to_context_ids,
        make_decoder,
        translate_codons_to_aa,
    )
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.protein.critic_scoring import load_critic, make_score_fn
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    ctx = dna_to_context_ids("ATG", stoi)

    score_fn = None
    if args.critic_ckpt:
        critic, critic_cfg, tokenizer, _ = load_critic(
            args.critic_ckpt, default_pooling="attention", device=decoder.device)
        score_fn = make_score_fn(critic, critic_cfg, tokenizer)

    configs = [{"critic_guided": guided, "red_stop_bias": red_bias}
               for guided in ([False, True] if score_fn else [False])
               for red_bias in (False, True)]

    results = []
    for config in configs:
        rng = np.random.default_rng(args.seed)
        stops, lengths, codon_rows = [], [], []
        t0 = time.time()
        for _ in range(args.n_samples):
            if config["critic_guided"]:
                out_ids, info = gen.generate_cds_critic_guided(
                    decoder, score_fn, ctx, stoi, itos,
                    target_codons=args.target_codons, hard_cap=args.hard_cap,
                    alpha=args.alpha, rng=rng,
                )
            elif config["red_stop_bias"]:
                out_ids, info = gen.generate_cds_red(
                    decoder, ctx, stoi, itos,
                    target_codons=args.target_codons, hard_cap=args.hard_cap,
                    termination_bias_enabled=True,
                    termination_stop_bias=args.stop_bias,
                    rng=rng,
                )
            else:
                out_ids, info = gen.generate_cds_constrained(
                    decoder, ctx, stoi, itos,
                    target_codons=args.target_codons, hard_cap=args.hard_cap,
                    rng=rng,
                )
            stops.append(bool(info["had_terminal_stop"]))
            lengths.append(int(info["generated_codons"]))
            codon_rows.append(codons_of(out_ids, len(ctx), itos))
        wall = time.time() - t0
        aa = [translate_codons_to_aa(c).rstrip("_*") for c in codon_rows]
        results.append({
            **config,
            "terminal_stop_rate": float(np.mean(stops)) if stops else None,
            "mean_codons": float(np.mean(lengths)) if lengths else None,
            "mean_protein_len": float(np.mean([len(a) for a in aa])) if aa else None,
            "wall_sec": round(wall, 3),
        })

    out = Path(args.out) if args.out else run_dir / "scores" / "ablation_sweep.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results, indent=2))
    return 0


__all__ = ["codons_of", "main", "parser"]


if __name__ == "__main__":
    raise SystemExit(main())
