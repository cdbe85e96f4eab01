"""Fused decode attention over the packed-lane KV cache.

Twin of ``genomics_lm_tpu/ops/decode_attention.py::decode_attention``:
the Pallas TPU kernel is replaced by the hand-written Hopper kernel in
``csrc/decode_attention.cu`` (its header note says what bounds it and what
the design does about that). The cache layout is the JAX package's packed
(L, B, S, P = Hkv·D): all heads' K (or V) of one position in one
contiguous row, so the per-step append is one (B, P) row write. The TPU's
block-diagonal query routing (``pack_query``/``extract_heads``) is a lane
trick that does not cross over: the kernel reads each kv head's D-slice of
the packed row directly.

``decode_attention`` runs ``decode_attention_reference`` (the twin of
``decode_attention_xla``) only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises — it never falls back. Each launch adds one
to ``decode_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genomics_lm_torch.ops.attention import NEG_INF

KERNEL_MAX_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8
_SMEM_LIMIT = 227 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check_args(q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads):
    """Validate the contract; returns (B, Hq, D, S, Hkv)."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(
            f"q must be (B, Hq, D) and the caches (L, B, S, P); got "
            f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, Hq, D = q.shape
    L, Bc, S, P = k_cache.shape
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError("k_scale and v_scale must be given together")
    if kv_heads is None:
        kv_heads = k_scale.shape[2] if quant else Hq
    Hkv = int(kv_heads)
    if Hkv < 1 or Hq % Hkv != 0:
        raise ValueError("n_head must be divisible by n_kv_head for GQA")
    if Bc != B or P != Hkv * D:
        raise ValueError(
            f"cache (L, B, S, P) = {tuple(k_cache.shape)} does not fit q "
            f"{tuple(q.shape)} with kv_heads={Hkv} (need B={B}, P={Hkv * D})")
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError("v_cache must match k_cache in shape and dtype")
    if tuple(mask_add.shape) != (B, S) or mask_add.dtype != torch.float32:
        raise ValueError(f"mask_add must be float32 (B, S) = ({B}, {S})")
    if q.dtype not in _FLOAT_DTYPES:
        raise ValueError(f"q must be a float tensor, got {q.dtype}")
    if quant:
        if k_cache.dtype != torch.int8:
            raise ValueError("scales are given but the cache is not int8")
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != (L, B, Hkv, S) or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 (L, B, Hkv, S) = "
                                 f"{(L, B, Hkv, S)}")
    elif k_cache.dtype not in _FLOAT_DTYPES:
        raise ValueError(f"an {k_cache.dtype} cache needs k_scale and v_scale")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    tensors = [q, k_cache, v_cache, mask_add] + ([k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("all decode_attention inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention inputs must be contiguous")
    return B, Hq, D, S, Hkv


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    mask_add: torch.Tensor,
    layer: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
    *,
    kv_heads: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (twin of ``decode_attention_xla``).

    The packed (B, S, P) layer is viewed as (B, S, Hkv, D) and contracted
    per head group; operands are rounded to ``compute_dtype`` and
    accumulated in float32. Returns (B, Hq, D) float32.
    """
    B, Hq, D = q.shape
    S = k_cache.shape[2]
    quant = k_scale is not None
    if kv_heads is None:
        kv_heads = k_scale.shape[2] if quant else Hq
    Hkv = int(kv_heads)
    G = Hq // Hkv
    qg = q.to(compute_dtype).reshape(B, Hkv, G, D).float()
    k_all = k_cache[layer].to(compute_dtype).reshape(B, S, Hkv, D).float()
    v_all = v_cache[layer].to(compute_dtype).reshape(B, S, Hkv, D).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_all) / torch.sqrt(
        torch.tensor(float(D), dtype=torch.float32))
    if quant:
        scores = scores * k_scale[layer][:, :, None, :]
    scores = scores + mask_add.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if quant:
        probs = probs * v_scale[layer][:, :, None, :]
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(compute_dtype).float(), v_all)
    return out.reshape(B, Hq, D).float()


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    mask_add: torch.Tensor,
    layer: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    kv_heads: int | None = None,
) -> torch.Tensor:
    """Fused single-token attention against layer ``layer`` of the cache.

    q:        (B, Hq, D) query for the one new token (float32/bf16/f16).
    k_cache:  (L, B, S, P) int8 (quantized) or float packed cache,
              P = kv_heads · D; a float cache has q's dtype.
    v_cache:  (L, B, S, P), same dtype as ``k_cache``.
    mask_add: (B, S) float32 additive mask (0 = attend, NEG_INF = blocked),
              shared across layers; must leave ≥ 1 finite slot per row.
    layer:    layer index into the cache (no slice copy).
    k_scale/v_scale: (L, B, Hkv, S) float32 per-vector scales when the
              cache is int8, else None.
    kv_heads: number of packed KV heads; inferred from the scale shape
              when quantized, else assumed = Hq (pass it for a float GQA cache).

    Returns (B, Hq, D) float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel; any other device raises.
    """
    B, Hq, D, S, Hkv = _check_args(
        q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads)
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads=Hkv)
    if q.device.type != "cuda":
        raise ValueError(
            f"decode_attention runs on cuda (kernel) or cpu (plain version), "
            f"not {q.device.type}")
    return _launch(q, k_cache, v_cache, mask_add, int(layer), k_scale, v_scale,
                   B, Hq, D, S, Hkv)


decode_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/decode_attention.cu``, built on first use."""
    from genomics_lm_torch.kernels.build import load

    fn = load("decode_attention").glm_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, B, Hq, D, S, Hkv):
    G = Hq // Hkv
    if k_cache.dtype != torch.int8 and k_cache.dtype != q.dtype:
        raise ValueError(f"a {k_cache.dtype} cache needs a {k_cache.dtype} query, "
                         f"got {q.dtype}")
    if D > KERNEL_MAX_HEAD_DIM or G > KERNEL_MAX_GROUP or B > 65535:
        raise ValueError(
            f"kernel takes head_dim <= {KERNEL_MAX_HEAD_DIM}, Hq/Hkv <= "
            f"{KERNEL_MAX_GROUP} and B <= 65535; got D={D}, G={G}, B={B}")
    smem = 4 * (2 * G * D + G * S + 4 * KERNEL_MAX_GROUP)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={S} with G={G} needs {smem} B of shared memory")
    esize = k_cache.element_size()
    vec_bytes = 8 if k_cache.dtype == torch.int8 else 16
    vec = ((D * esize) % vec_bytes == 0 and (Hkv * D * esize) % vec_bytes == 0
           and k_cache.data_ptr() % vec_bytes == 0
           and v_cache.data_ptr() % vec_bytes == 0)
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    fn = _kernel()
    quant = k_scale is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 mask_add.data_ptr(), out.data_ptr(),
                 B, S, Hkv, G, D, layer, 1.0 / float(D) ** 0.5,
                 _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (error {err})")
    decode_attention.launches += 1
    return out


__all__ = [
    "NEG_INF",
    "decode_attention",
    "decode_attention_reference",
]
