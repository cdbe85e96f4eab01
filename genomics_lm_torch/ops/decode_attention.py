"""Fused decode attention over the packed-lane KV cache.

Twin of ``genomics_lm_tpu/ops/decode_attention.py``. Its three Pallas TPU
kernels are replaced by hand-written Hopper kernels (each source's header
note says what bounds it and what the design does about that):

- ``decode_attention``: one query token per slot, ``csrc/decode_attention.cu``;
  it reads only the cache tiles that ``decode_live_tiles`` keeps;
- ``decode_attention_chunk``: T query tokens per slot with a per-query mask
  (the speculative verify chunk), ``csrc/decode_attention_chunk.cu``; for a
  bf16 query it reads only the cache tiles that ``chunk_live_tiles`` keeps;
- ``decode_attention_streamed``: ``decode_attention``'s function with the
  cache axis split over blocks and an online-softmax combine (split-S
  flash-decoding), ``csrc/decode_attention_streamed.cu``; each split reads
  only its live tiles.

The cache layout is the JAX package's packed (L, B, S, P = Hkv·D): all
heads' K (or V) of one position in one contiguous row, so the per-step
append is one (B, P) row write. The TPU's block-diagonal query routing
(``pack_query``/``pack_query_chunk``/``extract_heads``) is a lane trick that
does not cross over: the kernels read each kv head's D-slice of the packed
row directly.

Each wrapper runs its plain PyTorch version (``*_reference``) only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises — it
never falls back. Each launch adds one to the wrapper's ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genomics_lm_torch.ops.attention import NEG_INF

KERNEL_MAX_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8
KERNEL_MAX_CHUNK_ROWS = 32  # T·G query rows of one kv head in the chunk kernel
_SMEM_LIMIT = 227 * 1024
_CHUNK_TILE_S = 32  # float32 chunk kernel: V positions staged in shared memory at once
CHUNK_TILE = 64  # cache positions per tile of the tile-skipping kernels (read only when live)
_RESIDENT_BLOCKS_PER_SM = 4  # the single-token core's __launch_bounds__ minimum
_CHUNK_SMEM_ERROR = -2  # the chunk entry point's code for a layout over the opt-in limit
_KERNEL_WARPS = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_KERNEL_Q_DTYPES = (torch.float32, torch.bfloat16)  # chunk and streamed kernels


def _check_args(q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads,
                chunk=False):
    """Validate the contract; returns (B, Hq, D, S, Hkv).

    ``chunk``: q is (B, Hq, T, D) and ``mask_add`` (B, T, S), else q is
    (B, Hq, D) and ``mask_add`` (B, S).
    """
    q_dims = 4 if chunk else 3
    if q.dim() != q_dims or k_cache.dim() != 4:
        want = "(B, Hq, T, D)" if chunk else "(B, Hq, D)"
        raise ValueError(
            f"q must be {want} and the caches (L, B, S, P); got "
            f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, Hq, D = q.shape[0], q.shape[1], q.shape[-1]
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
    mask_shape = (B, q.shape[2], S) if chunk else (B, S)
    if tuple(mask_add.shape) != mask_shape or mask_add.dtype != torch.float32:
        raise ValueError(f"mask_add must be float32 {mask_shape}")
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


def _device_route(name: str, q: torch.Tensor) -> bool:
    """True for the plain version (CPU tensors), False for the kernel (CUDA)."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(
            f"{name} runs on cuda (kernel) or cpu (plain version), "
            f"not {q.device.type}")
    return False


def _check_kernel_dtypes(q, k_cache, allowed=_FLOAT_DTYPES):
    if q.dtype not in allowed:
        raise ValueError(f"the kernel takes a {' or '.join(map(str, allowed))} query, "
                         f"got {q.dtype}")
    if k_cache.dtype != torch.int8 and k_cache.dtype != q.dtype:
        raise ValueError(f"a {k_cache.dtype} cache needs a {k_cache.dtype} query, "
                         f"got {q.dtype}")


def _vector_loads(k_cache, v_cache, D, Hkv) -> bool:
    """Whether every head's D-slice starts on a 16-byte (8 for int8) boundary."""
    esize = k_cache.element_size()
    vec_bytes = 8 if k_cache.dtype == torch.int8 else 16
    return ((D * esize) % vec_bytes == 0 and (Hkv * D * esize) % vec_bytes == 0
            and k_cache.data_ptr() % vec_bytes == 0
            and v_cache.data_ptr() % vec_bytes == 0)


def _scale_ptrs(k_scale, v_scale):
    if k_scale is None:
        return None, None
    return k_scale.data_ptr(), v_scale.data_ptr()


# --- one query token per slot (kernel row 4) -------------------------------------


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
    if _device_route("decode_attention", q):
        return decode_attention_reference(
            q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads=Hkv)
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
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, B, Hq, D, S, Hkv):
    G = Hq // Hkv
    _check_kernel_dtypes(q, k_cache)
    if D > KERNEL_MAX_HEAD_DIM or G > KERNEL_MAX_GROUP or B > 65535:
        raise ValueError(
            f"kernel takes head_dim <= {KERNEL_MAX_HEAD_DIM}, Hq/Hkv <= "
            f"{KERNEL_MAX_GROUP} and B <= 65535; got D={D}, G={G}, B={B}")
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 *_scale_ptrs(k_scale, v_scale), mask_add.data_ptr(), out.data_ptr(),
                 B, S, Hkv, G, D, layer, 1.0 / float(D) ** 0.5,
                 _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (error {err})")
    decode_attention.launches += 1
    return out


# --- T query tokens per slot: the speculative verify chunk (kernel row 6) ---------


def decode_attention_chunk_reference(
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
    """Plain PyTorch version of the chunk kernel (twin of
    ``decode_attention_chunk_xla``).

    q (B, Hq, T, D) against the packed layer viewed as (B, S, Hkv, D), with
    the per-query additive mask (B, T, S); operands are rounded to
    ``compute_dtype`` and accumulated in float32. Returns (B, Hq, T, D)
    float32.
    """
    B, Hq, T, D = q.shape
    S = k_cache.shape[2]
    quant = k_scale is not None
    if kv_heads is None:
        kv_heads = k_scale.shape[2] if quant else Hq
    Hkv = int(kv_heads)
    G = Hq // Hkv
    qg = q.to(compute_dtype).reshape(B, Hkv, G, T, D).float()
    k_all = k_cache[layer].to(compute_dtype).reshape(B, S, Hkv, D).float()
    v_all = v_cache[layer].to(compute_dtype).reshape(B, S, Hkv, D).float()
    scores = torch.einsum("bhgtd,bshd->bhgts", qg, k_all) / torch.sqrt(
        torch.tensor(float(D), dtype=torch.float32))
    if quant:
        scores = scores * k_scale[layer][:, :, None, None, :]
    scores = scores + mask_add.float()[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    if quant:
        probs = probs * v_scale[layer][:, :, None, None, :]
    out = torch.einsum("bhgts,bshd->bhgtd", probs.to(compute_dtype).float(), v_all)
    return out.reshape(B, Hq, T, D).float()


def decode_attention_chunk(
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
    """Multi-query decode attention: T chunk queries per slot against layer
    ``layer`` of the cache (the speculative verify chunk).

    q:        (B, Hq, T, D) float32 or bf16 on the card (any float type on
              the CPU); the chunk's own K/V rows are already in the cache.
    mask_add: (B, T, S) float32 additive rows, one per query (cached
              positions plus the intra-chunk causal prefix); each row must
              leave ≥ 1 finite slot.
    The caches, scales and ``kv_heads`` are as in ``decode_attention``.

    Returns (B, Hq, T, D) float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which reads the cache once for all T queries
    of a slot (a bf16 query: only the tiles ``chunk_live_tiles`` keeps, on
    the tensor cores); any other device raises.
    """
    B, Hq, D, S, Hkv = _check_args(
        q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads, chunk=True)
    if _device_route("decode_attention_chunk", q):
        return decode_attention_chunk_reference(
            q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads=Hkv)
    return _launch_chunk(q, k_cache, v_cache, mask_add, int(layer), k_scale, v_scale,
                         B, Hq, D, S, Hkv)


decode_attention_chunk.launches = 0


@functools.lru_cache(maxsize=None)
def _chunk_kernel():
    """The C entry point of ``csrc/decode_attention_chunk.cu``, built on first use."""
    from genomics_lm_torch.kernels.build import load

    fn = load("decode_attention_chunk").glm_decode_attention_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def chunk_live_tiles(mask_add: torch.Tensor) -> torch.Tensor:
    """(B, ceil(S / CHUNK_TILE)) boolean: the cache tiles the bf16 chunk kernel reads.

    A position is dead when every one of the slot's T mask rows is at most
    NEG_INF / 2 there: the softmax gives it weight exactly 0 (each row keeps
    at least one finite entry). A tile is read when it holds a live
    position. The kernel decides this from the mask itself; the tests and
    ``chip_smoke.py`` use this statement of the rule.
    """
    B, _, S = mask_add.shape
    live = (mask_add > 0.5 * NEG_INF).any(dim=1)
    live = torch.nn.functional.pad(live, (0, -S % CHUNK_TILE), value=False)
    return live.view(B, -1, CHUNK_TILE).any(dim=-1)


def decode_live_tiles(mask_add: torch.Tensor) -> torch.Tensor:
    """(B, ceil(S / CHUNK_TILE)) boolean: the cache tiles the single-token
    kernels read, for a (B, S) mask: ``chunk_live_tiles`` with T = 1.

    ``decode_attention`` reads exactly these; ``decode_attention_streamed``
    too when its splits are multiples of ``CHUNK_TILE`` positions (the
    default; a split's tiles start at the split's first position).
    """
    return chunk_live_tiles(mask_add[:, None, :])


def _launch_chunk(q, k_cache, v_cache, mask_add, layer, k_scale, v_scale,
                  B, Hq, D, S, Hkv):
    G = Hq // Hkv
    T = q.shape[2]
    _check_kernel_dtypes(q, k_cache, _KERNEL_Q_DTYPES)
    if D > KERNEL_MAX_HEAD_DIM or not 1 <= T * G <= KERNEL_MAX_CHUNK_ROWS or B > 65535:
        raise ValueError(
            f"chunk kernel takes head_dim <= {KERNEL_MAX_HEAD_DIM}, 1 <= T x Hq/Hkv <= "
            f"{KERNEL_MAX_CHUNK_ROWS} and B <= 65535; got D={D}, T={T}, G={G}, B={B}")
    if q.dtype == torch.float32:  # the SIMT kernel's scores grow with S
        R = T * G
        smem = 4 * (R * D + R * S + _CHUNK_TILE_S * D + _KERNEL_WARPS * KERNEL_MAX_CHUNK_ROWS)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"S={S} with T={T}, G={G} needs {smem} B of shared memory")
    vec = _vector_loads(k_cache, v_cache, D, Hkv)
    out = torch.empty((B, Hq, T, D), dtype=torch.float32, device=q.device)
    fn = _chunk_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 *_scale_ptrs(k_scale, v_scale), mask_add.data_ptr(), out.data_ptr(),
                 B, S, Hkv, G, T, D, layer, 1.0 / float(D) ** 0.5,
                 _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], int(vec), stream)
    if err == _CHUNK_SMEM_ERROR:
        raise ValueError(f"S={S} with T={T}, G={G}, D={D} needs more shared memory "
                         f"than a block may have")
    if err != 0:
        raise RuntimeError(f"decode_attention_chunk kernel launch failed (error {err})")
    decode_attention_chunk.launches += 1
    return out


# --- the cache streamed in S-chunks with an online softmax (kernel row 5) ---------


def decode_attention_streamed_reference(
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
    block_s: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the streamed kernel: the JAX kernel's
    online-softmax recurrence over S-chunks of ``block_s`` positions
    (default: 128 when S is a multiple of it, else all of S), in float32.

    Per chunk: scores (times the k scale), the running max ``m`` over every
    score of the chunk, ``p = exp(s - m)`` zeroed where the mask blocks the
    key (so a chunk that is wholly masked adds exactly nothing), the
    running sum ``l`` and the P·V accumulator (p times the v scale) both
    rescaled by ``exp(m_old - m)``. The result is ``acc / max(l, 1e-30)``:
    (B, Hq, D) float32. Unlike the JAX kernel, a ragged last chunk is kept.
    """
    B, Hq, D = q.shape
    S = k_cache.shape[2]
    quant = k_scale is not None
    if kv_heads is None:
        kv_heads = k_scale.shape[2] if quant else Hq
    Hkv = int(kv_heads)
    G = Hq // Hkv
    sb = int(block_s) if block_s else (128 if S % 128 == 0 else S)
    inv_sqrt_d = 1.0 / float(D) ** 0.5
    qg = q.to(compute_dtype).reshape(B, Hkv, G, D).float()
    m = torch.full((B, Hkv, G, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, sb):
        n = min(sb, S - s0)
        k = k_cache[layer, :, s0:s0 + n].to(compute_dtype).reshape(B, n, Hkv, D).float()
        v = v_cache[layer, :, s0:s0 + n].to(compute_dtype).reshape(B, n, Hkv, D).float()
        s = torch.einsum("bhgd,bshd->bhgs", qg, k) * inv_sqrt_d
        if quant:
            s = s * k_scale[layer, :, :, None, s0:s0 + n]
        mrow = mask_add[:, None, None, s0:s0 + n].float()
        s = s + mrow
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mrow > 0.5 * NEG_INF, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if quant:
            p = p * v_scale[layer, :, :, None, s0:s0 + n]
        acc = acc * alpha + torch.einsum("bhgs,bshd->bhgd", p.to(compute_dtype).float(), v)
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(B, Hq, D)


def decode_attention_streamed(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    mask_add: torch.Tensor,
    layer: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    kv_heads: int | None = None,
    block_s: int | None = None,
) -> torch.Tensor:
    """``decode_attention``'s contract, with the cache streamed in S-chunks.

    On the card the S axis is split over blocks of ``block_s`` positions
    (default: ``stream_block_s`` of the batch, the cache length and the
    card's SM count), each block reading only its live tiles and keeping
    its own (max, sum, P·V) carry; the last block of a slot's kv head to
    finish combines the splits. q is float32 or bf16 on the card.
    On the CPU the plain version runs the JAX kernel's recurrence over
    chunks of ``block_s``. Returns (B, Hq, D) float32.
    """
    B, Hq, D, S, Hkv = _check_args(
        q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads)
    if block_s is not None and int(block_s) < 1:
        raise ValueError(f"block_s must be positive, got {block_s}")
    if _device_route("decode_attention_streamed", q):
        return decode_attention_streamed_reference(
            q, k_cache, v_cache, mask_add, layer, k_scale, v_scale, kv_heads=Hkv,
            block_s=block_s)
    return _launch_streamed(q, k_cache, v_cache, mask_add, int(layer), k_scale, v_scale,
                            B, Hq, D, S, Hkv, block_s)


decode_attention_streamed.launches = 0


def stream_block_s(B: int, Hkv: int, S: int, sm_count: int) -> int:
    """Positions per split of the streamed kernel when the caller names none.

    As many splits as the card holds (slot, kv head, split) blocks at once
    (``_RESIDENT_BLOCKS_PER_SM`` per SM), in whole tiles (a multiple of
    ``CHUNK_TILE`` positions, so a split reads the cache's own tiles), and
    no split at all once the batch alone fills them: a second wave of
    blocks costs more than a split saves.
    """
    splits = min(_RESIDENT_BLOCKS_PER_SM * sm_count // max(1, B * Hkv), -(-S // CHUNK_TILE))
    if splits <= 1:
        return S
    chunk = -(-S // splits)
    return min(S, -(-chunk // CHUNK_TILE) * CHUNK_TILE)


@functools.lru_cache(maxsize=None)
def _streamed_kernel():
    """The C entry point of ``csrc/decode_attention_streamed.cu``, built on first use."""
    from genomics_lm_torch.kernels.build import load

    fn = load("decode_attention_streamed").glm_decode_attention_streamed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _split_counters(device, n: int) -> torch.Tensor:
    """n int32 zeros on ``device`` that outlive the launch: the streamed
    kernel counts each (slot, kv head)'s finished splits there, and the
    block that combines them sets its count back to 0."""
    have = _COUNTERS.get(device)
    if have is None or have.numel() < n:
        have = _COUNTERS[device] = torch.zeros(n, dtype=torch.int32, device=device)
    return have


_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _launch_streamed(q, k_cache, v_cache, mask_add, layer, k_scale, v_scale,
                     B, Hq, D, S, Hkv, block_s):
    G = Hq // Hkv
    _check_kernel_dtypes(q, k_cache, _KERNEL_Q_DTYPES)
    if block_s is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        block_s = stream_block_s(B, Hkv, S, sms)
    block_s = min(int(block_s), S)
    splits = -(-S // block_s)
    if D > KERNEL_MAX_HEAD_DIM or G > KERNEL_MAX_GROUP or B > 65535 or splits > 65535:
        raise ValueError(
            f"streamed kernel takes head_dim <= {KERNEL_MAX_HEAD_DIM}, Hq/Hkv <= "
            f"{KERNEL_MAX_GROUP}, B <= 65535 and S/block_s <= 65535; got D={D}, "
            f"G={G}, B={B}, splits={splits}")
    dev = q.device
    parts = []  # (m, l, acc, counters) of the splits; one split writes the output itself
    if splits > 1:
        m_part = torch.empty((B, Hkv, splits, G), dtype=torch.float32, device=dev)
        parts = [m_part, torch.empty_like(m_part),
                 torch.empty((B, Hkv, splits, G, D), dtype=torch.float32, device=dev),
                 _split_counters(dev, B * Hkv)]
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    fn = _streamed_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 *_scale_ptrs(k_scale, v_scale), mask_add.data_ptr(),
                 *([t.data_ptr() for t in parts] or [None] * 4), out.data_ptr(),
                 B, S, Hkv, G, D, layer, block_s, 1.0 / float(D) ** 0.5,
                 _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_streamed kernel launch failed (error {err})")
    decode_attention_streamed.launches += 1
    return out


__all__ = [
    "CHUNK_TILE",
    "KERNEL_MAX_CHUNK_ROWS",
    "NEG_INF",
    "chunk_live_tiles",
    "decode_attention",
    "decode_attention_chunk",
    "decode_attention_chunk_reference",
    "decode_attention_reference",
    "decode_attention_streamed",
    "decode_attention_streamed_reference",
    "decode_live_tiles",
    "stream_block_s",
]
