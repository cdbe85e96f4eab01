"""Mine codon motifs from a trained run (twin of ``scripts/mine_motifs.py``,
the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.mine_motifs <run_id> --npz train_bs512.npz \\
        [--window 9] [--stride 1] [--n_clusters 100] [--max_windows 256] \\
        [--out motifs.json] [--checkpoint best.npz] [--device cpu]

The first ``--max_windows`` rows of the split go through one
``hidden_states`` pass (``evals/motifs.py::extract_window_embeddings``,
windows holding a PAD skipped); the window embeddings are clustered on the
host with the port's KMeans (``evals/clustering.py``, sklearn's arithmetic
without sklearn), and each cluster reports its consensus, size, known-motif
matches and PWM entropy summary in ``<run>/scores/motifs.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--npz", required=True, help="packed NPZ split to mine")
    ap.add_argument("--window", type=int, default=9)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--n_clusters", type=int, default=100)
    ap.add_argument("--max_windows", type=int, default=256,
                    help="sequences sampled from the split")
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.evals.motifs import (
        MotifClusterer,
        cluster_consensus,
        cluster_pwm_report,
        extract_window_embeddings,
        match_known_motifs,
    )
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, itos_list, _ = load_codon_model(run_dir, args.checkpoint, device=args.device)
    itos = dict(enumerate(itos_list))

    ds = PackedDataset(args.npz)
    rows = min(len(ds), args.max_windows)
    x, _ = ds.fetch_batch(list(range(rows)))
    emb, meta = extract_window_embeddings(
        model, cfg.replace(dropout=0.0), x,
        window_size=args.window, stride=args.stride,
        exclude_ids=[0],  # skip PAD-containing windows
    )
    n_clusters = min(args.n_clusters, max(2, len(meta) // 2))
    clusterer = MotifClusterer(n_clusters=n_clusters)
    labels = clusterer.fit_predict(emb)
    consensus = cluster_consensus(x, meta, labels, itos)
    pwm_stats = cluster_pwm_report(x, meta, labels, itos)
    report = {
        "n_windows": len(meta),
        "n_clusters": n_clusters,
        "clusters": {
            str(label): {
                "consensus": text,
                "size": int((labels == label).sum()),
                "known_motifs": match_known_motifs(text),
                **{
                    key: value
                    for key, value in pwm_stats.get(label, {}).items()
                    if key != "per_position_entropy_bits"
                },
                "per_position_entropy_bits": pwm_stats.get(label, {}).get(
                    "per_position_entropy_bits", []
                ),
            }
            for label, text in consensus.items()
        },
    }
    out = Path(args.out) if args.out else run_dir / "scores" / "motifs.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(f"[motifs] {len(meta)} windows → {n_clusters} clusters → {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
