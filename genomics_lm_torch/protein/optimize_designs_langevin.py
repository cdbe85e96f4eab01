"""Latent Langevin optimization of designed proteins (twin of
``scripts/optimize_designs_langevin.py``, the same flags plus ``--device``):

    python -m genomics_lm_torch.protein.optimize_designs_langevin \
        --designs_csv candidates.csv --critic_ckpt best_critic.npz \
        --ebm_ckpt best_ebm.npz --out optimized.csv [--steps 50] [--lr 0.05] \
        [--noise_std 0.01] [--lambda_reg 0.1] [--device cpu]

Each design's ``protein`` (or ``sequence``) runs through
``protein/sampler.py::latent_langevin_sample`` on the device; the CSV holds
the initial and optimized sequences, the first and last energies and the
changed positions.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--designs_csv", required=True,
                    help="CSV with id,protein columns (e.g. design-loop output)")
    ap.add_argument("--critic_ckpt", required=True)
    ap.add_argument("--ebm_ckpt", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--noise_std", type=float, default=0.01)
    ap.add_argument("--lambda_reg", type=float, default=0.1)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.protein._cli import critic_from_checkpoint
    from genomics_lm_torch.protein.common import load_frozen
    from genomics_lm_torch.protein.sampler import latent_langevin_sample
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
    from genomics_lm_torch.training.checkpoints import load_checkpoint

    tokenizer = ProteinTokenizer()
    critic, critic_cfg, _ = critic_from_checkpoint(args.critic_ckpt, args.device,
                                                   pooling="attention")
    ebm = load_frozen(load_checkpoint(args.ebm_ckpt), "ebm", None,
                      critic.backbone.token_embedding.device)

    rows = []
    with open(args.designs_csv) as f:
        for record in csv.DictReader(f):
            protein = record.get("protein") or record.get("sequence")
            if not protein:
                continue
            optimized, energies = latent_langevin_sample(
                ebm, critic, critic_cfg, tokenizer, protein,
                steps=args.steps, lr=args.lr, noise_std=args.noise_std,
                lambda_reg=args.lambda_reg,
            )
            rows.append({
                "id": record.get("id") or record.get("candidate"),
                "initial": protein,
                "optimized": optimized,
                "initial_energy": energies[0] if energies else None,
                "final_energy": energies[-1] if energies else None,
                "changed_positions": sum(a != b for a, b in zip(protein, optimized)),
            })
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()) if rows else ["id"])
        writer.writeheader()
        writer.writerows(rows)
    print(json.dumps({"optimized": len(rows)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
