"""Build termination-head replay data from generated prefixes (twin of
``scripts/build_generated_prefix_replay.py``, the same flags plus
``--device``).

    python -m genomics_lm_torch.generation.build_generated_prefix_replay <run_id> \
        --npz val_bs512.npz --out replay.jsonl [--n_samples 64] [--prefix_codons 6] \
        [--target_codons 24] [--hard_cap 48] [--bucket_edges 0,3,10,30] [--device cpu]

Held-out rows give prefixes; ``generate_cds_constrained`` (require a
terminal stop) continues each on the decoder's device, and every generated
state is labelled with its distance-to-stop bucket, in the replay JSONL
that ``data/replay.py`` loads.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("run_id")
    ap.add_argument("--npz", required=True, help="held-out split for prefixes")
    ap.add_argument("--out", required=True, help="replay JSONL output")
    ap.add_argument("--n_samples", type=int, default=64)
    ap.add_argument("--prefix_codons", type=int, default=6)
    ap.add_argument("--target_codons", type=int, default=24)
    ap.add_argument("--hard_cap", type=int, default=48)
    ap.add_argument("--bucket_edges", default="0,3,10,30")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.evals.playground import make_decoder
    from genomics_lm_torch.generation import constrained as gen
    from genomics_lm_torch.tokenizers.codon import STOP_IDS
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    rng = np.random.default_rng(args.seed)
    edges = [int(e) for e in args.bucket_edges.split(",")]

    ds = PackedDataset(args.npz)
    rows = rng.choice(len(ds), min(args.n_samples, len(ds)), replace=False)
    x, _ = ds.fetch_batch(rows)

    def bucket(distance: int | None) -> int:
        if distance is None:
            return len(edges)
        return int(sum(distance > e for e in edges))

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    written = 0
    with out_path.open("w") as f:
        for row in x:
            ids, codons = [], 0
            for t in row:
                t = int(t)
                if t == 0:
                    break
                ids.append(t)
                if len(itos[t]) == 3 and "<" not in itos[t]:
                    codons += 1
                if codons >= args.prefix_codons:
                    break
            gen_ids, info = gen.generate_cds_constrained(
                decoder, ids, stoi, itos,
                target_codons=args.target_codons, hard_cap=args.hard_cap,
                require_terminal_stop=True, rng=rng,
            )
            # true distance-to-stop labels over the generated region
            stop_positions = [
                i for i, t in enumerate(gen_ids) if t in set(STOP_IDS)
            ]
            labels = []
            for pos in range(len(ids), len(gen_ids)):
                ahead = [s for s in stop_positions if s >= pos]
                distance = (ahead[0] - pos) if ahead else None
                labels.append({"pos": pos, "class": bucket(distance)})
            if labels:
                f.write(json.dumps({"ids": gen_ids, "labels": labels}) + "\n")
                written += 1
    print(f"[replay] wrote {written} records → {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
