"""Attention masks: <SEP> segment labels and the structured attend mask.

``segment_ids_from_tokens`` is the twin of
``genomics_lm_tpu/ops/masks.py::segment_ids_from_tokens``: position i may
attend to j only when both carry the same running count of <SEP> tokens
(reference ``TinyGPT.build_attention_mask``). ``structure_mask`` lowers
the structured mask inputs (causal, window, segment ids) to a dense
boolean mask, for the einsum attention and the flash kernels' plain
versions.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # the score of a masked (query, key) pair


def segment_ids_from_tokens(idx: torch.Tensor, sep_id: int) -> torch.Tensor:
    """Segment labels via running count of <SEP> tokens. (B, T) int32.

    The <SEP> token itself belongs to the *following* segment, exactly as
    the reference's ``cumsum(idx == sep_id)``.
    """
    return torch.cumsum((idx == sep_id).to(torch.int32), dim=-1, dtype=torch.int32)


def structure_mask(T: int, S: int, *, causal: bool = True, window: int | None = None,
                   segment_ids: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """(B or 1, 1, T, S) boolean attend mask, queries bottom-right aligned
    (query i sits at key position i + S - T): causal, the one-sided window
    ``q_pos - k_pos < window``, and same segment from (B, S) ids whose
    trailing T entries label the queries."""
    q_pos = torch.arange(T, device=device) + (S - T)
    k_pos = torch.arange(S, device=device)
    dist = q_pos[:, None] - k_pos[None, :]
    mask = dist >= 0 if causal else torch.ones((T, S), dtype=torch.bool, device=device)
    if window is not None:
        mask = mask & (dist < int(window))
    mask = mask[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, S - T:, None] == segment_ids[:, None, :])[:, None]
    return mask


__all__ = ["NEG_INF", "segment_ids_from_tokens", "structure_mask"]
