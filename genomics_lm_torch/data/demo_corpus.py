"""Write the structured synthetic demo corpus as a records TSV (the port's
own copy of ``scripts/make_demo_corpus.py``: the same bytes for the same
arguments).

N genes (ATG start, weighted TAA/TAG/TGA stop) across G genera x M
genomes: each genus has its own codon-usage dialect (a Dirichlet-drawn
unigram over sense codons), and codon successors follow a first-order
Markov chain; ``--coupling`` is the share of next-codon mass that comes
from the chain's preferred successors rather than the dialect.

    python -m genomics_lm_torch.data.demo_corpus --out records.tsv [--genes 660] [--seed 0]
    python -m genomics_lm_torch.data.pipeline_prepare --records_tsv records.tsv \\
        --out_dir dataset --block_size 256 --group_by genome --skip_homology

Columns: sequence, source_id, genome, genus (the schema
``pipeline_prepare --records_tsv`` reads).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

CODONS = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"]
STOPS = ("TAA", "TAG", "TGA")
STOP_WEIGHTS = (0.6, 0.2, 0.2)


def _cdf(p: np.ndarray) -> np.ndarray:
    """Each row's cumulative weights over its total, as ``Generator.choice``
    forms them."""
    cdf = np.cumsum(p, axis=-1)
    cdf /= cdf[..., -1:]
    return cdf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="records.tsv")
    ap.add_argument("--genes", type=int, default=660)
    ap.add_argument("--genera", type=int, default=4)
    ap.add_argument("--genomes_per_genus", type=int, default=3)
    ap.add_argument("--min_codons", type=int, default=40)
    ap.add_argument("--max_codons", type=int, default=220)
    ap.add_argument("--coupling", type=float, default=0.55,
                    help="fraction of next-codon mass from the Markov "
                         "successor structure vs the genus dialect")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    sense = [c for c in CODONS if c not in STOPS]
    V = len(sense)

    # per-genus dialect: concentrated Dirichlet unigram over sense codons
    dialects = rng.dirichlet(np.full(V, 0.3), size=args.genera)
    # shared successor structure: each codon prefers ~4 successors
    succ = np.full((V, V), 1e-3)
    for i in range(V):
        succ[i, rng.choice(V, 4, replace=False)] = rng.dirichlet(np.ones(4)) * 10
    succ /= succ.sum(axis=1, keepdims=True)

    # per-genus transition matrices (mix depends only on the genus)
    genus_trans = []
    for genus in range(args.genera):
        t = (args.coupling * succ
             + (1 - args.coupling) * dialects[genus][None, :])
        genus_trans.append(t / t.sum(axis=1, keepdims=True))

    # ``rng.choice(V, p=row)`` draws one double u and returns the first index
    # whose normalized cumulative weight exceeds u; the cumulative rows are
    # built once here, so each draw below is that same u and searchsorted
    dialect_cdf, trans_cdf = _cdf(dialects), [_cdf(t) for t in genus_trans]
    stop_cdf = _cdf(np.asarray(STOP_WEIGHTS))

    rows = []
    for g in range(args.genes):
        genus = g % args.genera
        genome = (g // args.genera) % args.genomes_per_genus
        cdf = trans_cdf[genus]
        n = int(rng.integers(args.min_codons, args.max_codons + 1))
        state = int(dialect_cdf[genus].searchsorted(rng.random(), side="right"))
        body = []
        for _ in range(n):
            body.append(sense[state])
            state = int(cdf[state].searchsorted(rng.random(), side="right"))
        stop = STOPS[int(stop_cdf.searchsorted(rng.random(), side="right"))]
        seq = "ATG" + "".join(body) + stop
        rows.append((seq, f"gene{g:04d}",
                     f"genus{genus}_genome{genome}", f"genus{genus}"))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        f.write("sequence\tsource_id\tgenome\tgenus\n")
        for seq, sid, genome, genus in rows:
            f.write(f"{seq}\t{sid}\t{genome}\t{genus}\n")
    print(f"wrote {len(rows)} genes to {out} "
          f"({args.genera} genera x {args.genomes_per_genus} genomes, "
          f"coupling {args.coupling})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
