"""Extract protein-critic latents for downstream probes (twin of
``scripts/extract_protein_embeddings.py``, the same flags plus ``--device``):

    python -m genomics_lm_torch.protein.extract_protein_embeddings \
        --critic_ckpt best_critic.npz --input proteins.jsonl --out emb.npz \
        [--batch_size 16] [--device cpu]

Records (JSONL or FASTA) in file order, batches padded to their longest
row, ``extract_latent`` on the device; ``emb.npz`` holds ``X`` (N, D) and
``ids``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--critic_ckpt", required=True)
    ap.add_argument("--input", required=True, help="JSONL/FASTA of protein sequences")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from genomics_lm_torch.models.protein import extract_latent
    from genomics_lm_torch.protein._cli import critic_from_checkpoint
    from genomics_lm_torch.protein.data import load_records
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer

    tokenizer = ProteinTokenizer()
    model, cfg, _ = critic_from_checkpoint(args.critic_ckpt, args.device, pooling="mean")
    device = model.backbone.token_embedding.device

    records = load_records(args.input)
    ids = [r.get("id", f"p{i}") for i, r in enumerate(records)]

    X = []
    for start in range(0, len(records), args.batch_size):
        chunk = records[start : start + args.batch_size]
        toks = [
            [tokenizer.bos_token_id]
            + tokenizer.encode_sequence(r["sequence"])[: cfg.block_size - 2]
            + [tokenizer.eos_token_id]
            for r in chunk
        ]
        width = max(len(t) for t in toks)
        input_ids = np.full((len(toks), width), tokenizer.pad_token_id, np.int32)
        mask = np.zeros((len(toks), width), np.int32)
        for row, t in enumerate(toks):
            input_ids[row, : len(t)] = t
            mask[row, : len(t)] = 1
        with torch.no_grad():
            z = extract_latent(model, cfg, torch.as_tensor(input_ids, device=device),
                               torch.as_tensor(mask, device=device))
        X.append(z.cpu().numpy().astype(np.float32))
    X = np.concatenate(X) if X else np.zeros((0, cfg.n_embd), np.float32)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, X=X, ids=np.asarray(ids))
    print(json.dumps({"embeddings": list(X.shape), "out": str(out)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
