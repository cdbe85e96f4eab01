"""Attention: the einsum path and the flash dispatch of
``genomics_lm_tpu/ops/attention.py``.

Prompt prefill runs the einsum path, as the JAX package does
(``generation/decode.py:123-131``): at admission shapes the materialized
scores are small, and the JAX code computes them outside any Pallas
kernel. ``impl="flash"`` goes to ``ops/flash_attention.py`` (the CUDA
flash kernels on the card, their plain versions on the CPU). The kernels
mask their own ragged edges, so the JAX fallback of off-grid lengths to
the einsum path (``attention.py:100-106``) has no counterpart here.

Dropout on the einsum path draws its keep mask from the flash kernels'
Philox stream (``flash_attention.philox_keep``), so the two paths drop the
same probabilities for the same seed.

GQA is computed with grouped einsums — query heads are viewed as
(kv_head, group), so keys/values are never repeated per query head.
Scores and the softmax run in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch

from genomics_lm_torch.ops.flash_attention import flash_attention, philox_keep
from genomics_lm_torch.ops.masks import NEG_INF, structure_mask


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    seed: torch.Tensor | None = None,
    return_probs: bool = False,
    dropout_heads: tuple[int, int] | None = None,
):
    """Scaled dot-product attention via einsum.

    q: (B, Hq, T, D); k, v: (B, Hkv, S, D) with Hq a multiple of Hkv.
    ``mask`` is boolean, broadcastable to (B, Hq, T, S), True = attend.
    When mask is None a causal mask aligned to the last query is applied.
    Dropout acts on the probabilities when ``seed`` (a one-element int32
    tensor) is given and the rate is > 0, keyed as the flash kernels' (with
    ``dropout_heads``, as heads h0 .. h0 + Hq - 1 of H). ``return_probs`` also returns the
    float32 probabilities (B, Hq, T, S) before dropout, as JAX's
    ``sdpa_xla(..., return_probs=True)``.
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
    probs_out = probs.reshape(B, Hq, T, S) if return_probs else None
    if dropout_rate > 0.0 and seed is not None:
        keep = philox_keep(seed, B, Hq, T, S, dropout_rate,
                           dropout_heads).view(B, Hkv, G, T, S)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.einsum(
        "bhgts,bhsd->bhgtd", probs.to(v.dtype).float(), v.float()
    ).to(q.dtype)
    out = out.reshape(B, Hq, T, D)
    return (out, probs_out) if return_probs else out


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    attention_window: int | None = None,
    dropout_rate: float = 0.0,
    seed: torch.Tensor | None = None,
    impl: str = "xla",
    dropout_heads: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Dispatch between the einsum path (``impl="xla"``) and flash attention.

    ``segment_ids``/``attention_window`` are the structured mask inputs the
    flash kernels consume without materializing (B, T, S); the einsum path
    lowers them to a dense mask here. Bottom-right aligned: with T < S the
    queries are the suffix of the key sequence (matches the JAX
    ``attention`` and ``sdpa_xla``). ``dropout_heads`` = (h0, H): q holds
    heads h0 .. h0 + Hq - 1 of H (a tensor-parallel rank's), keyed as those
    heads of the whole model.
    """
    if impl == "flash":
        if mask is not None:
            raise ValueError(
                "impl='flash' consumes structured masks (segment_ids / "
                "attention_window), not a dense mask; pass impl='xla' "
                "or express the mask structurally")
        return flash_attention(q, k, v, segment_ids=segment_ids,
                               attention_window=attention_window,
                               dropout_rate=dropout_rate, seed=seed,
                               dropout_heads=dropout_heads)
    if impl != "xla":
        raise ValueError(f"Unknown attention impl: {impl!r}")
    if segment_ids is not None or attention_window is not None:
        dense = structure_mask(q.shape[2], k.shape[2], window=attention_window,
                               segment_ids=segment_ids, device=q.device)
        mask = dense if mask is None else (mask & dense)
    return sdpa(q, k, v, mask=mask, dropout_rate=dropout_rate, seed=seed,
                dropout_heads=dropout_heads)


__all__ = ["NEG_INF", "attention", "sdpa"]
