"""Sanity KPI bundle for a trained run (twin of ``scripts/sanity_kpis.py``,
the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.sanity_kpis <run_id> --val_npz val.npz \\
        [--out kpis.json] [--run_root runs] [--device cuda:0]

Quick invariants in one JSON verdict: the checkpoint loads, the validation
perplexity (``evaluate_perplexity``, the flash forward on the card) beats
the uniform one, the final validation loss of ``scores/curves.csv`` is not
the worst, constrained generation from ``ATG`` (the cached decoder at
B 1: the decode kernel on the card) emits codons, and a pooled embedding
is finite. Runs on ``--device`` (default: the CUDA card); exit 1 when a
check fails. Writes ``--out`` (default ``<run>/scores/sanity_kpis.json``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--val_npz", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.embeddings import extract_embeddings, ids_from_dna
    from genomics_lm_torch.evals.perplexity import evaluate_perplexity
    from genomics_lm_torch.evals.playground import dna_to_context_ids, load_codon_model
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.generation.decode import CachedDecoder
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    checks = {}

    model, cfg, itos, stoi = load_codon_model(run_dir, device=args.device)
    cfg = cfg.replace(dropout=0.0)
    checks["checkpoint_loads"] = True

    ppl = evaluate_perplexity(model, cfg, args.val_npz, batch_size=32)
    uniform_ppl = float(len(itos) - 1)
    checks["val_perplexity"] = ppl["perplexity"]
    checks["beats_uniform"] = ppl["perplexity"] < uniform_ppl

    curves_path = run_dir / "scores" / "curves.csv"
    if curves_path.exists():
        rows = curves_path.read_text().strip().splitlines()[1:]
        vals = [float(r.split(",")[2]) for r in rows if r]
        checks["curve_epochs"] = len(vals)
        checks["final_val_not_worst"] = (not vals) or vals[-1] <= max(vals)

    ids, info = gen.generate_cds_constrained(
        CachedDecoder(model, cfg), dna_to_context_ids("ATG", stoi), stoi, itos,
        target_codons=4, hard_cap=8, rng=np.random.default_rng(0),
    )
    checks["generation_emits_codons"] = info["generated_codons"] > 0

    emb = extract_embeddings(
        model, cfg, np.stack([ids_from_dna("ATGAAATAA", cfg.block_size)])
    )
    checks["embeddings_finite"] = bool(np.isfinite(emb).all())

    verdict = all(v for k, v in checks.items() if isinstance(v, bool))
    report = {"checks": checks, "passed": verdict}
    out = Path(args.out) if args.out else run_dir / "scores" / "sanity_kpis.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0 if verdict else 1


if __name__ == "__main__":
    raise SystemExit(main())
