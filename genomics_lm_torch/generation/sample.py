"""Multinomial sampling from a trained run (twin of ``scripts/sample.py``,
the same flags plus ``--device``).

    python -m genomics_lm_torch.generation.sample <run_id> [--dna ATG] \
        [--max_new_tokens 64] [--temperature 1.0] [--topk 0] [--seed 0] [--device cpu]

Prints the generated DNA (the context's codons included) and a line with
the stop reason and the codon count.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--dna", default="ATG")
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--topk", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.playground import dna_to_context_ids, make_decoder
    from genomics_lm_torch.generation.constrained import generate_model_raw
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    ids = dna_to_context_ids(args.dna, stoi)
    out_ids, info = generate_model_raw(
        decoder, ids, stoi, itos, args.max_new_tokens,
        temperature=args.temperature, topk=args.topk,
        rng=np.random.default_rng(args.seed),
    )
    dna = "".join(itos[t] for t in out_ids if len(itos[t]) == 3 and "<" not in itos[t])
    print(dna)
    print(f"[sample] stop_reason={info['stop_reason']} codons={info['generated_codons']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
