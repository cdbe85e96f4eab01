"""Int8 quantization for serving: weight-only linears and the KV cache
(twin of ``genomics_lm_tpu/ops/quant.py``).

Both schemes are symmetric. Decode at serving batch sizes reads every
weight and the whole KV cache each step, so int8 storage halves or
quarters those bytes.

- **Weight-only int8** (``quantize_params``): per-output-channel scales on
  every block linear (QKV, attention projection, MLP; a MoE model's
  experts and router stay full precision). The product runs in
  the activation dtype on the converted weight, ``(x @ w_q.T) * scale +
  b`` (``models/codon_gpt.py::_linear``), as JAX computes it outside any
  Pallas kernel. Embeddings, layer norms, the LM head and the auxiliary
  heads stay float32.
- **Int8 KV cache** (``quantize_kv``, used by ``generation/decode.py``):
  per-vector scales over the head dim. The scales factor out of both
  attention contractions — ``q·(k_q·s_k) = s_k·(q·k_q)`` and
  ``Σ p·(v_q·s_v) = Σ (p·s_v)·v_q`` — so decode attention reads the raw
  int8 cache and never materializes a dequantized copy.

Layouts: JAX holds a linear weight as (fan_in, fan_out), the port as
(fan_out, fan_in). ``quantize_weight`` takes the port's layout and reduces
over fan_in, the last axis; the result is the transpose of JAX's for the
same float32 weight, bit for bit (the same float32 division and
round-half-to-even).
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
_EPS = 1e-8


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a linear weight.

    ``w``: (..., fan_out, fan_in), the port's layout. Returns ``(w_q int8
    (..., fan_out, fan_in), scale float32 (..., fan_out))`` with ``w ≈ w_q *
    scale[..., None]``: ``amax`` over fan_in, floored at 1e-8, over 127.
    """
    wf = w.float()
    scale = wf.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS) / INT8_MAX
    w_q = torch.round(wf / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return w_q, scale.squeeze(-1)


def dequantize_weight(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return w_q.float() * scale[..., None]


def quantize_params(model):
    """Quantize every transformer-block linear of ``model`` to int8, in place.

    Each block linear of the attention (query, key and value, or the fused
    ``qkv``, and ``proj``) and of the MLP becomes an ``Int8Linear``
    holding ``w_q`` and ``scale``; its bias stays float32 and its dense
    weight is dropped, so the device holds the int8 bytes only. The
    embeddings, layer norms, LM head and auxiliary heads are left as they
    are. Returns ``model``.

    The fused ``qkv`` weight is quantized as one linear: its scales are per
    output row, so its int8 rows and scales are exactly JAX's query, key
    and value quantized apart and concatenated (``codon_gpt.py:212-225``).

    A MoE model quantizes its attention linears only: the experts run
    through the dispatch's batched products, not ``_linear``, and they and
    the router stay float32, as in JAX (``quant.py:84-91``), so a MoE model
    serves with ``--int8_weights``.

    Refuses a model with LoRA adapters (rebuilding a linear from its
    weight and bias would drop the trained factors; merge first), as JAX
    refuses an unmerged tree.
    """
    from genomics_lm_torch.models.codon_gpt import (
        Int8Linear,
        LoRA,
        block_linears,
        set_block_linear,
    )

    cfg = model.cfg
    if any(isinstance(m, LoRA) for m in model.modules()):
        raise ValueError(
            "cannot int8-quantize an unmerged LoRA checkpoint — the adapter "
            "factors would be silently dropped; fold them into the dense "
            "weights first (training/merge_lora.py or training.lora.merge_lora)")
    for block in model.blocks:
        for (group, name), lin in block_linears(block, cfg, with_qkv=True).items():
            if isinstance(lin, Int8Linear):
                continue
            set_block_linear(block, cfg, group, name, Int8Linear.from_linear(lin))
    return model


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x``: (..., head_dim) → ``(x_q int8, scale f32 (...,))``, x ≈ x_q·scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(_EPS) / INT8_MAX
    x_q = torch.round(xf / scale[..., None]).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return x_q, scale


__all__ = [
    "INT8_MAX",
    "dequantize_weight",
    "quantize_kv",
    "quantize_params",
    "quantize_weight",
]
