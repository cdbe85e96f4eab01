"""Does generation past a stop codon look like a 3' UTR terminator? (twin of
``scripts/test_utr_generation.py``, the same flags plus ``--device``; the
module drops the script's ``test_`` prefix so that pytest never collects
it).

    python -m genomics_lm_torch.evals.utr_generation <run_id> [--n_samples 8] \\
        [--prefix_codons 10] [--utr_codons 12] [--seed 0] [--out report.json] [--device cpu]

For each of ``--n_samples`` random CDS prefixes (``ATG`` and
``--prefix_codons`` - 1 codons drawn from six), ``--utr_codons`` tokens
sampled at temperature 1 after the prefix and after the same prefix closed
by ``TAA``, every draw from one generator seeded with ``--seed``, one token
a cached decoder step (the card unless ``--device`` names another). Both
sets' codon continuations are scored for hairpins, the longest poly-T run
and GC (``termination_motifs.py``); the report gives the means and the
post-stop uplifts. Writes ``<run>/scores/utr_generation.json`` (or
``--out``) and prints it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--n_samples", type=int, default=8)
    ap.add_argument("--prefix_codons", type=int, default=10)
    ap.add_argument("--utr_codons", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.playground import dna_to_context_ids, make_decoder
    from genomics_lm_torch.evals.termination_motifs import (
        gc_fraction,
        hairpin_score,
        max_poly_t_run,
    )
    from genomics_lm_torch.generation.decode import sample_token
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    rng = np.random.default_rng(args.seed)

    def continue_tokens(ids: list[int], n_tokens: int) -> str:
        ids = list(ids)
        out = []
        for _ in range(n_tokens):
            logits = decoder.next_logits(ids)
            tok = sample_token(np.asarray(logits), 1.0, 0, rng)
            ids.append(int(tok))
            text = itos[int(tok)]
            if len(text) == 3 and "<" not in text:
                out.append(text)
        return "".join(out)

    # prefix inside a CDS vs the same prefix terminated by a stop codon
    in_cds, post_stop = [], []
    for _ in range(args.n_samples):
        body = "".join(rng.choice(["GCA", "AAA", "CTG", "GAT", "TCC", "CGT"])
                       for _ in range(args.prefix_codons - 1))
        prefix = "ATG" + body
        in_cds.append(continue_tokens(dna_to_context_ids(prefix, stoi), args.utr_codons))
        post_stop.append(continue_tokens(dna_to_context_ids(prefix + "TAA", stoi),
                                         args.utr_codons))

    def score(seqs):
        rows = [{"hairpin": hairpin_score(s), "poly_t": max_poly_t_run(s),
                 "gc": gc_fraction(s)} for s in seqs if s]
        return {k: float(np.mean([r[k] for r in rows])) if rows else None
                for k in ("hairpin", "poly_t", "gc")}

    report = {
        "n_samples": args.n_samples,
        "in_cds_continuation": score(in_cds),
        "post_stop_continuation": score(post_stop),
    }
    if report["in_cds_continuation"]["hairpin"] is not None and \
            report["post_stop_continuation"]["hairpin"] is not None:
        report["utr_hairpin_uplift"] = (report["post_stop_continuation"]["hairpin"]
                                        - report["in_cds_continuation"]["hairpin"])
        report["utr_poly_t_uplift"] = (report["post_stop_continuation"]["poly_t"]
                                       - report["in_cds_continuation"]["poly_t"])
    out = Path(args.out) if args.out else run_dir / "scores" / "utr_generation.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


__all__ = ["main", "parser"]


if __name__ == "__main__":
    raise SystemExit(main())
