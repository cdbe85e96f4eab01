"""Reset-and-Discard efficiency on a trained run (twin of
``scripts/benchmark_red.py``, the same flags plus ``--device``).

Single-attempt constrained generation against ReD retries from the same
generator: terminal-stop success rate and tokens spent. Writes the JSON
report to ``--out`` (default ``<run>/scores/benchmark_red.json``) and
prints it.

    python -m genomics_lm_torch.generation.benchmark_red <run_id> [--n_prefixes 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--n_prefixes", type=int, default=16)
    ap.add_argument("--target_codons", type=int, default=24)
    ap.add_argument("--hard_cap", type=int, default=72)
    ap.add_argument("--max_attempts", type=int, default=5)
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
    rng = np.random.default_rng(args.seed)
    ctx = dna_to_context_ids("ATG", stoi)

    single, red = [], []
    for _ in range(args.n_prefixes):
        _, info1 = gen.generate_cds_constrained(
            decoder, ctx, stoi, itos, args.target_codons, args.hard_cap,
            require_terminal_stop=True, rng=rng,
        )
        single.append(info1)
        _, info2 = gen.generate_cds_red(
            decoder, ctx, stoi, itos, args.target_codons, args.hard_cap,
            max_attempts=args.max_attempts, rng=rng,
        )
        red.append(info2)

    def summarize(infos, tokens_key):
        return {
            "terminal_stop_rate": float(np.mean([i["had_terminal_stop"] for i in infos])),
            "mean_tokens": float(np.mean([i.get(tokens_key, i["generated_codons"])
                                          for i in infos])),
        }

    report = {
        "single_attempt": summarize(single, "generated_codons"),
        "red": {**summarize(red, "total_tokens_red"),
                "mean_attempts": float(np.mean([i["attempts"] for i in red]))},
    }
    out = Path(args.out) if args.out else run_dir / "scores" / "benchmark_red.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
