"""In-silico mutagenesis: per-position Δlog-P for all 64 codon substitutions
(twin of ``genomics_lm_tpu/evals/mutations.py``).

For one CDS, the log-probability of every codon at every position given
its left context, reported beside the wild-type codon's. One forward
under ``torch.no_grad`` gives every position of a window (the flash
forward at batch 1 on the card); a CDS longer than the block streams
through overlapping windows, as in JAX.
"""

from __future__ import annotations

import csv
from pathlib import Path

import torch

from genomics_lm_torch.models.codon_gpt import CodonGPT, forward
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.tokenizers.codon import BOS_ID, CODON_BASE_ID, CODONS, stoi
from genomics_lm_torch.utils.device import module_device


def dna_to_ids(dna: str) -> list[int]:
    """DNA → [BOS, codons...] skipping ambiguous codons."""
    s = dna.strip().upper().replace("U", "T")
    L = (len(s) // 3) * 3
    ids = [BOS_ID]
    for i in range(0, L, 3):
        idx = stoi.get(s[i : i + 3])
        if idx is not None:
            ids.append(idx)
    return ids


def score_mutations(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    dna: str,
) -> list[dict]:
    """Per-position rows: wild-type codon, WT log-prob, all 64 mutant log-probs.

    Position t's distribution is the model's next-token prediction given
    tokens < t (BOS-anchored). Long sequences stream through overlapping
    windows.
    """
    ids = dna_to_ids(dna)
    if len(ids) < 2:
        return []
    device = module_device(model)

    @torch.no_grad()
    def logp_fn(window):
        idx = torch.tensor([window], dtype=torch.long, device=device)
        logits, _ = forward(model, cfg, idx)
        return torch.log_softmax(logits.float(), dim=-1)[0].cpu().numpy()

    rows: list[dict] = []
    block = cfg.block_size
    position = 1  # first codon position in ids
    while position < len(ids):
        # window must include at least one token before `position` so the
        # model's next-token prediction at position-1 is available
        start = max(0, position - block + 1)
        window = ids[start : start + block]
        logp = logp_fn(window)
        # scores for positions in this window beyond already-emitted ones
        for local in range(position - start, len(window)):
            target_global = start + local
            if target_global >= len(ids):
                break
            wt_id = ids[target_global]
            pred = logp[local - 1]  # distribution for token at `local`
            codon_logps = pred[CODON_BASE_ID : CODON_BASE_ID + 64]
            wt_logp = float(pred[wt_id])
            rows.append(
                {
                    "position": target_global - 1,  # codon index (0-based)
                    "wt_codon": CODONS[wt_id - CODON_BASE_ID]
                    if wt_id >= CODON_BASE_ID
                    else str(wt_id),
                    "wt_logp": wt_logp,
                    **{
                        f"logp_{codon}": float(codon_logps[i])
                        for i, codon in enumerate(CODONS)
                    },
                    **{
                        f"delta_{codon}": float(codon_logps[i]) - wt_logp
                        for i, codon in enumerate(CODONS)
                    },
                }
            )
        position = start + len(window)
    return rows


def write_mutation_tsv(rows: list[dict], out_path: str | Path) -> None:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        out_path.write_text("")
        return
    with out_path.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()), delimiter="\t")
        writer.writeheader()
        writer.writerows(rows)


__all__ = ["dna_to_ids", "score_mutations", "write_mutation_tsv"]
