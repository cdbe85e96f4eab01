"""Plain attention: the einsum path of ``genomics_lm_tpu/ops/attention.py``.

Prompt prefill runs this path, as the JAX package does
(``generation/decode.py:123-131``): at admission shapes the materialized
scores are small, and the JAX code computes them outside any Pallas
kernel. The flash branch (``ops/flash_attention.py``, the training
kernels) is not ported yet.

GQA is computed with grouped einsums — query heads are viewed as
(kv_head, group), so keys/values are never repeated per query head.
Scores and the softmax run in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention via einsum.

    q: (B, Hq, T, D); k, v: (B, Hkv, S, D) with Hq a multiple of Hkv.
    ``mask`` is boolean, broadcastable to (B, Hq, T, S), True = attend.
    When mask is None a causal mask aligned to the last query is applied.
    """
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if Hq % Hkv != 0:
        raise ValueError("n_head must be divisible by n_kv_head for GQA")
    G = Hq // Hkv
    # bf16·bf16 products are exact in f32, so upcasting first equals an
    # f32-accumulating dot on the working dtype
    qg = q.reshape(B, Hkv, G, T, D).float()
    # the f32 value of 1/sqrt(D), as the JAX code computes it
    scale = float(1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32)))
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * scale

    if mask is None:
        pos_t = torch.arange(T, device=q.device)[:, None] + (S - T)
        pos_s = torch.arange(S, device=q.device)[None, :]
        mask = (pos_t >= pos_s)[None, None, :, :]
    mask = torch.broadcast_to(mask, (B, Hq, T, S)).reshape(B, Hkv, G, T, S)
    scores = scores.masked_fill(~mask, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgts,bhsd->bhgtd", probs.to(v.dtype).float(), v.float()
    ).to(q.dtype)
    return out.reshape(B, Hq, T, D)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    attention_window: int | None = None,
) -> torch.Tensor:
    """Causal attention with the structured mask inputs lowered to a dense mask.

    Bottom-right aligned: with T < S the queries are the suffix of the key
    sequence (matches the JAX ``attention`` and ``sdpa_xla``).
    """
    if segment_ids is not None or attention_window is not None:
        T, S = q.shape[2], k.shape[2]
        q_pos = torch.arange(T, device=q.device) + (S - T)
        k_pos = torch.arange(S, device=q.device)
        distance = q_pos[:, None] - k_pos[None, :]
        causal = distance >= 0
        if attention_window is not None:
            causal = causal & (distance < int(attention_window))
        dense = causal[None, None, :, :]
        if segment_ids is not None:
            seg_eq = segment_ids[:, S - T:, None] == segment_ids[:, None, :]
            dense = dense & seg_eq[:, None, :, :]
        mask = dense if mask is None else (mask & dense)
    return sdpa(q, k, v, mask=mask)


__all__ = ["NEG_INF", "attention", "sdpa"]
