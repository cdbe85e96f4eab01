"""Int8 KV-cache quantization (twin of ``genomics_lm_tpu/ops/quant.py::quantize_kv``).

Per-vector symmetric scales over the head dim. The scales factor out of
both attention contractions — ``q·(k_q·s_k) = s_k·(q·k_q)`` and
``Σ p·(v_q·s_v) = Σ (p·s_v)·v_q`` — so decode attention reads the raw
int8 cache and never materializes a dequantized copy.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
_EPS = 1e-8


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x``: (..., head_dim) → ``(x_q int8, scale f32 (...,))``, x ≈ x_q·scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(_EPS) / INT8_MAX
    x_q = torch.round(xf / scale[..., None]).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return x_q, scale


__all__ = ["INT8_MAX", "quantize_kv"]
