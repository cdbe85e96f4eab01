"""Query a trained codon LM: next codon, generation, scoring (twin of
``scripts/query_model.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.generation.query_model <run_id> \
        --mode next|generate|score [--dna ATG...] [--device cpu]

``next`` prints the top-k next-codon distribution, ``generate`` a CDS from
``generate_cds_constrained`` with its ``info``, ``score`` the sequence's
log-probability; each as the JAX script's JSON. ``--mode interactive`` is
not ported and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Query a trained codon LM")
    ap.add_argument("run_id")
    ap.add_argument("--mode", choices=["next", "generate", "score", "interactive"],
                    default="next")
    ap.add_argument("--dna", default="ATG", help="DNA prompt")
    ap.add_argument("--top_k", type=int, default=10)
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--target_codons", type=int, default=32)
    ap.add_argument("--hard_cap", type=int, default=96)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--topk_sample", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.mode == "interactive":
        raise NotImplementedError("--mode interactive is not ported")

    import numpy as np

    from genomics_lm_torch.evals.playground import (
        dna_to_context_ids,
        make_decoder,
        query_next_codon,
        score_sequence,
    )
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, args.checkpoint, device=args.device)
    rng = np.random.default_rng(args.seed)
    ids = dna_to_context_ids(args.dna, stoi)

    if args.mode == "next":
        rows = query_next_codon(decoder, ids, itos, top_k=args.top_k)
        print(json.dumps({"prompt": args.dna, "next": rows}, indent=2))
    elif args.mode == "generate":
        out_ids, info = gen.generate_cds_constrained(
            decoder, ids, stoi, itos,
            target_codons=args.target_codons, hard_cap=args.hard_cap,
            temperature=args.temperature, topk=args.topk_sample, rng=rng,
        )
        dna = "".join(itos[t] for t in out_ids if len(itos[t]) == 3 and "<" not in itos[t])
        print(json.dumps({"dna": dna, "ids": out_ids, "info": info}, indent=2))
    else:  # score
        print(json.dumps(score_sequence(decoder, ids), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
