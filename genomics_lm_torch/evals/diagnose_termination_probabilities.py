"""Stop-codon probability mass along a sampled CDS (twin of
``scripts/diagnose_termination_probabilities.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.evals.diagnose_termination_probabilities <run_id> \\
        [--dna ATG] [--n_steps 32] [--seed 0] [--out termination_probabilities.json] \\
        [--run_root runs] [--device cpu]

From ``<BOS_CDS>`` and the codons of ``--dna``, ``n_steps`` cached steps of
the run's decoder (``make_decoder``: the decode kernel on the card, at
B 1). Each step records the context length, the stop codons' probability
mass, the top token and its probability, then samples the next codon from
the CDS-masked logits with ``generation/decode.py::sample_token`` under
``np.random.default_rng(seed)``. Writes the rows to ``--out`` (default
``<run>/scores/termination_probabilities.json``) and prints their mean and
largest stop mass.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--dna", default="ATG")
    ap.add_argument("--n_steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.playground import dna_to_context_ids, make_decoder
    from genomics_lm_torch.generation.constrained import cds_token_ids, stop_token_ids
    from genomics_lm_torch.generation.decode import sample_token
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    rng = np.random.default_rng(args.seed)
    ids = dna_to_context_ids(args.dna, stoi)
    stop_ids = stop_token_ids(stoi)
    allowed = cds_token_ids(itos)

    rows = []
    for step in range(args.n_steps):
        logits = decoder.next_logits(ids)
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        rows.append({
            "step": step,
            "context_len": len(ids),
            "stop_mass": float(sum(probs[s] for s in stop_ids)),
            "top_token": itos[int(np.argmax(probs))],
            "top_prob": float(probs.max()),
        })
        masked = np.full_like(logits, -np.inf)
        masked[allowed] = logits[allowed]
        ids.append(sample_token(masked, 1.0, 0, rng))

    out = Path(args.out) if args.out else run_dir / "scores" / "termination_probabilities.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=2) + "\n")
    mass = [r["stop_mass"] for r in rows]
    print(json.dumps({"mean_stop_mass": float(np.mean(mass)),
                      "max_stop_mass": float(np.max(mass)),
                      "steps": len(rows)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
