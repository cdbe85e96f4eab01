"""Segment labels for the <SEP>-segment attention mask.

Twin of ``genomics_lm_tpu/ops/masks.py::segment_ids_from_tokens``: position
i may attend to j only when both carry the same running count of <SEP>
tokens (reference ``TinyGPT.build_attention_mask``).
"""

from __future__ import annotations

import torch


def segment_ids_from_tokens(idx: torch.Tensor, sep_id: int) -> torch.Tensor:
    """Segment labels via running count of <SEP> tokens. (B, T) int32.

    The <SEP> token itself belongs to the *following* segment, exactly as
    the reference's ``cumsum(idx == sep_id)``.
    """
    return torch.cumsum((idx == sep_id).to(torch.int32), dim=-1, dtype=torch.int32)


__all__ = ["segment_ids_from_tokens"]
