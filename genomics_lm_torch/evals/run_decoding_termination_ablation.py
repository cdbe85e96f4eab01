"""Terminal-stop rates under termination stop-bias strengths (twin of
``scripts/run_decoding_termination_ablation.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.evals.run_decoding_termination_ablation <run_id> \\
        [--biases 0,1,2,4] [--n_samples 16] [--target_codons 24] [--hard_cap 72] \\
        [--bias_window 8] [--seed 0] [--out termination_ablation.json] \\
        [--run_root runs] [--device cpu]

For each bias, ``n_samples`` CDS from ``ATG`` through
``generation/constrained.py::generate_cds_constrained`` (the run's cached
decoder: the decode kernel on the card, at B 1) with a terminal stop
required and the bias on when it is positive, from a fresh
``default_rng(seed)``: the terminal-stop and hard-cap rates, the mean
codons and the mean biased steps. Writes ``--out`` (default
``<run>/scores/termination_ablation.json``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--biases", default="0,1,2,4")
    ap.add_argument("--n_samples", type=int, default=16)
    ap.add_argument("--target_codons", type=int, default=24)
    ap.add_argument("--hard_cap", type=int, default=72)
    ap.add_argument("--bias_window", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.playground import dna_to_context_ids, make_decoder
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    ctx = dna_to_context_ids("ATG", stoi)

    rows = []
    for bias in (float(b) for b in args.biases.split(",")):
        rng = np.random.default_rng(args.seed)
        infos = [
            gen.generate_cds_constrained(
                decoder, ctx, stoi, itos,
                target_codons=args.target_codons, hard_cap=args.hard_cap,
                require_terminal_stop=True,
                termination_bias_enabled=bias > 0,
                termination_stop_bias=bias,
                termination_bias_window=args.bias_window,
                rng=rng,
            )[1]
            for _ in range(args.n_samples)
        ]
        rows.append({
            "stop_bias": bias,
            "terminal_stop_rate": float(np.mean([i["had_terminal_stop"] for i in infos])),
            "hard_cap_rate": float(np.mean([i["hit_hard_cap"] for i in infos])),
            "mean_codons": float(np.mean([i["generated_codons"] for i in infos])),
            "mean_bias_steps": float(np.mean([i["termination_bias_steps"] for i in infos])),
        })
    out = Path(args.out) if args.out else run_dir / "scores" / "termination_ablation.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=2) + "\n")
    print(json.dumps(rows, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
