"""Audit mined motif clusters for structural termination signals (twin of
``scripts/audit_structural_motifs.py``, the same flags).

    python -m genomics_lm_torch.evals.audit_structural_motifs <run_id> \\
        [--motifs_json motifs.json] [--hairpin_threshold 12.0] [--run_root runs]

Each cluster consensus of ``mine_motifs``'s report (default
``<run>/scores/motifs.json``) gets its hairpin score, longest poly-T run and
GC fraction (``evals/termination_motifs.py``); clusters at or over the
hairpin threshold or with a poly-T run of 5 are structural. Writes
``<run>/scores/structural_motif_audit.json``. Host only.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--motifs_json", default=None)
    ap.add_argument("--hairpin_threshold", type=float, default=12.0)
    ap.add_argument("--run_root", default="runs")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.termination_motifs import (
        gc_fraction,
        hairpin_score,
        max_poly_t_run,
    )
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    path = Path(args.motifs_json) if args.motifs_json else run_dir / "scores" / "motifs.json"
    if not path.exists():
        raise SystemExit(f"{path} not found — run mine_motifs first")
    clusters = json.loads(path.read_text()).get("clusters", {})
    if isinstance(clusters, dict):
        clusters = [{"cluster": label, **info} for label, info in clusters.items()]

    rows = []
    for cluster in clusters:
        consensus = (cluster.get("consensus") or "").replace(" ", "").upper()
        dna = "".join(c for c in consensus if c in "ACGT")
        if not dna:
            continue
        rows.append({
            "cluster": cluster.get("cluster"),
            "size": cluster.get("size"),
            "consensus": dna,
            "hairpin_score": hairpin_score(dna),
            "max_poly_t": max_poly_t_run(dna),
            "gc": round(gc_fraction(dna), 4),
        })
    rows.sort(key=lambda r: -r["hairpin_score"])

    structural = [r for r in rows if r["hairpin_score"] >= args.hairpin_threshold
                  or r["max_poly_t"] >= 5]
    report = {
        "clusters_audited": len(rows),
        "structural_clusters": len(structural),
        "hairpin_threshold": args.hairpin_threshold,
        "top_structural": rows[:10],
    }
    out = run_dir / "scores" / "structural_motif_audit.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
