"""Rank mined motif clusters against the known-motif library (twin of
``scripts/benchmark_motifs.py``, the same flags).

    python -m genomics_lm_torch.evals.benchmark_motifs <run_id> [--motifs_json motifs.json]

SequenceMatcher similarity of each cluster consensus in ``mine_motifs``'s
``motifs.json`` to the curated prokaryotic motifs, exact containments, and
the PWM scores carried through; writes ``<run>/scores/motif_benchmark.json``.
Host-only: no model runs.
"""

from __future__ import annotations

import argparse
import json
from difflib import SequenceMatcher
from pathlib import Path

from genomics_lm_torch.utils.cli import resolve_run_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("run_id")
    ap.add_argument("--motifs_json", default=None,
                    help="default: <run>/scores/motifs.json (mine_motifs output)")
    ap.add_argument("--run_root", default="runs")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.motifs import KNOWN_MOTIFS

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    path = Path(args.motifs_json) if args.motifs_json else (
        run_dir / "scores" / "motifs.json"
    )
    if not path.exists():
        raise SystemExit(f"{path} not found — run genomics_lm_torch.evals.mine_motifs first")
    mined = json.loads(path.read_text())
    clusters = mined.get("clusters", {})
    if isinstance(clusters, dict):  # mine_motifs keys clusters by label
        clusters = [{"cluster": label, **info} for label, info in clusters.items()]

    rows = []
    for cluster in clusters:
        consensus = (cluster.get("consensus") or "").replace(" ", "").upper()
        best_name, best_score, contained = None, 0.0, []
        for name, info in KNOWN_MOTIFS.items():
            motif = info["sequence"]
            score = SequenceMatcher(None, consensus, motif).ratio()
            if motif in consensus:
                contained.append(name)
                score = 1.0
            if score > best_score:
                best_name, best_score = name, score
        row = {
            "cluster": cluster.get("cluster", cluster.get("label")),
            "consensus": consensus,
            "size": cluster.get("size"),
            "best_match": best_name,
            "similarity": round(best_score, 4),
            "exact_containments": contained,
        }
        # Information-content scoring (reference motif_analysis.py PWM path):
        # carried through from mine_motifs.py when present.
        for key in ("pwm_consensus", "mean_entropy_bits", "min_entropy_bits",
                    "information_content_bits"):
            if key in cluster:
                row[key] = cluster[key]
        rows.append(row)
    rows.sort(key=lambda r: -r["similarity"])

    report = {
        "clusters": len(rows),
        "clusters_with_exact_match": sum(bool(r["exact_containments"]) for r in rows),
        "ranked": rows,
    }
    out = run_dir / "scores" / "motif_benchmark.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
