"""Flash attention with causal, window and segment masks and dropout.

Twin of ``genomics_lm_tpu/ops/flash_attention.py::flash_attention``. The
three Pallas TPU kernels (forward ``_fwd_kernel``, backward
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) are replaced by three
hand-written Hopper kernels in ``csrc/flash_attention.cu``; its header note
says what bounds them and what the design does about that. They are wired
into a ``torch.autograd.Function`` as the JAX ``custom_vjp`` wires the
Pallas kernels: the forward saves (q, k, v, segment ids, seed, O, LSE),
the backward computes ``delta = rowsum(dO * O)`` in plain torch and runs
the dQ and the dK/dV kernel.

What crosses over is the contract, not the TPU's blocking:

- q is (B, Hq, T, D), k and v are (B, Hkv, S, D), Hq a multiple of Hkv.
  With T < S the queries are the suffix of the keys (``q_offset = S - T``).
- Masks are computed inline: causal, one-sided window
  ``q_pos - k_pos < window``, and same segment from a (B, S) id row.
- Scale 1/sqrt(D) multiplies q in the forward and the scores in the
  backward; masked scores are -1e30; ``l_safe = max(l, 1e-30)``; O, dQ,
  dK and dV have q's dtype, the LSE is float32.
- Dropout acts on the probabilities after the row normaliser is taken
  from the undropped ones; keep iff ``bits >= floor(rate * 2**32)``,
  scaled by 1/(1 - rate); the backward uses ``ds = pd*dpd - p*delta``.

The TPU's hardware PRNG cannot be reproduced here, so the keep bits come
from Philox-4x32-10 keyed on (seed, b*Hq + h) with the counter
(i, j // 4, 0, 0); word ``j % 4`` of the output decides element (i, j).
A keep bit depends on neither tile size nor kernel: the three kernels and
the plain version (``philox_keep``, integer tensor arithmetic) agree bit
for bit. The seed is a one-element int32 tensor on q's device, drawn by
the caller from its generator, which the kernels read themselves: no host
read per layer.

``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` run their plain
versions (``flash_forward_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``) only for tensors on the CPU; for CUDA tensors
they launch their kernel or raise. Each launch adds one to the wrapper's
``launches`` count.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from genomics_lm_torch.ops.masks import NEG_INF, structure_mask

KERNEL_MAX_HEAD_DIM = 128
_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # the plain versions
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# --- Philox-4x32-10 -------------------------------------------------------------


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``m`` and
    the 32-bit values ``x`` (int64 tensor), without int64 overflow."""
    a = m * (x & 0xFFFF)  # < 2**48
    b = m * (x >> 16)     # < 2**48
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter, key) -> list[torch.Tensor]:
    """Philox-4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    words. ``counter`` is 4 broadcastable words, ``key`` 2; returns 4 words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def dropout_threshold(rate: float) -> int:
    """Keep iff bits >= this (the JAX kernel's ``uint32(rate * 2**32)``)."""
    return int(float(rate) * float(2**32))


def philox_keep(seed: torch.Tensor, B: int, Hq: int, T: int, S: int,
                rate: float) -> torch.Tensor:
    """(B, Hq, T, S) boolean keep mask of the kernels' dropout stream."""
    dev = seed.device
    s = seed.reshape(()).long() & _MASK32
    bh = torch.arange(B * Hq, device=dev, dtype=torch.long).view(B, Hq, 1, 1, 1)
    i = torch.arange(T, device=dev, dtype=torch.long).view(1, 1, T, 1, 1)
    j4 = torch.arange((S + 3) // 4, device=dev, dtype=torch.long).view(1, 1, 1, -1, 1)
    zero = torch.zeros((), device=dev, dtype=torch.long)
    words = philox4x32_10((i, j4, zero, zero), (s, bh))
    bits = torch.cat([torch.broadcast_to(w, (B, Hq, T, j4.shape[3], 1)) for w in words],
                     dim=-1)
    return bits.reshape(B, Hq, T, -1)[..., :S] >= dropout_threshold(rate)


# --- plain versions ---------------------------------------------------------------


def _grouped_mask(q, k, segment_ids, cfg: "FlashCfg") -> torch.Tensor:
    """(B or 1, 1, 1, T, S) attend mask, broadcastable to (B, Hkv, G, T, S)."""
    return structure_mask(q.shape[2], k.shape[2], causal=cfg.causal, window=cfg.window,
                          segment_ids=segment_ids, device=q.device)[:, :, None]


@functools.lru_cache(maxsize=None)
def _scale(D: int) -> float:
    """1/sqrt(D) rounded to float32, as the kernels and JAX hold it."""
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32))


def _grouped_keep(seed, B, Hq, Hkv, T, S, rate, device):
    if rate <= 0.0:
        return None
    return philox_keep(seed.to(device), B, Hq, T, S, rate).view(B, Hkv, Hq // Hkv, T, S)


def flash_forward_reference(q, k, v, segment_ids, seed, cfg: "FlashCfg"):
    """Plain PyTorch version of the forward kernel: (O, LSE).

    Float32 throughout, as the kernel: a global row max where the kernel
    keeps an online one, otherwise the same operations on the same rounded
    operands. O has q's dtype, LSE (B, Hq, T) is float32.
    """
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().view(B, Hkv, G, T, D) * _scale(D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qf, k.float())
    mask = _grouped_mask(q, k, segment_ids, cfg)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l_safe = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    keep = _grouped_keep(seed, B, Hq, Hkv, T, S, cfg.dropout_rate, q.device)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - cfg.dropout_rate), 0.0)
    acc = torch.einsum("bhgts,bhsd->bhgtd", p, v.float())
    out = (acc / l_safe).to(q.dtype).reshape(B, Hq, T, D)
    lse = (m + torch.log(l_safe)).reshape(B, Hq, T)
    return out, lse


def _backward_probs(q, k, v, segment_ids, seed, dout, lse, delta, cfg: "FlashCfg"):
    """(P dropped, dS) of the backward, (B, Hkv, G, T, S) float32: P is
    recomputed from the LSE with the forward's masks and keep bits."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    s = _scale(D) * torch.einsum("bhgtd,bhsd->bhgts", q.float().view(B, Hkv, G, T, D),
                                 k.float())
    mask = _grouped_mask(q, k, segment_ids, cfg)
    p = torch.where(mask, torch.exp(s - lse.view(B, Hkv, G, T, 1)), 0.0)
    dpd = torch.einsum("bhgtd,bhsd->bhgts", dout.float().view(B, Hkv, G, T, D), v.float())
    keep = _grouped_keep(seed, B, Hq, Hkv, T, S, cfg.dropout_rate, q.device)
    pd = p if keep is None else torch.where(keep, p / (1.0 - cfg.dropout_rate), 0.0)
    return pd, pd * dpd - p * delta.view(B, Hkv, G, T, 1)


def flash_bwd_dq_reference(q, k, v, segment_ids, seed, dout, lse, delta, cfg: "FlashCfg"):
    """Plain PyTorch version of the dQ kernel. ``delta`` = rowsum(dO * O)."""
    B, Hq, T, D = q.shape
    _, ds = _backward_probs(q, k, v, segment_ids, seed, dout, lse, delta, cfg)
    dq = _scale(D) * torch.einsum("bhgts,bhsd->bhgtd", ds, k.float())
    return dq.reshape(B, Hq, T, D).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, segment_ids, seed, dout, lse, delta, cfg: "FlashCfg"):
    """Plain PyTorch version of the dK/dV kernel: (dK, dV), summed over each
    kv head's query group in float32 and rounded once to q's dtype."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    pd, ds = _backward_probs(q, k, v, segment_ids, seed, dout, lse, delta, cfg)
    dk = _scale(D) * torch.einsum("bhgts,bhgtd->bhsd", ds,
                                  q.float().view(B, Hkv, Hq // Hkv, T, D))
    dv = torch.einsum("bhgts,bhgtd->bhsd", pd, dout.float().view(B, Hkv, Hq // Hkv, T, D))
    return dk.to(q.dtype), dv.to(q.dtype)


# --- the kernels ----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entry points of ``csrc/flash_attention.cu``, built on first use."""
    from genomics_lm_torch.kernels.build import load

    lib = load("flash_attention")
    common = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_uint, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fns = {}
    for name, n_ptrs in (("glm_flash_fwd", 7), ("glm_flash_bwd_dq", 9),
                         ("glm_flash_bwd_dkv", 10)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + common
        fns[name] = fn
    return fns


def _launch(name: str, tensors: list, q, k, cfg: "FlashCfg") -> None:
    """Launch one kernel on ``tensors`` (pointers in the C argument order;
    None for an absent segment row or seed) after checking their layout."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    given = [t for t in tensors if t is not None]
    if not all(t.is_contiguous() and t.device == q.device for t in given):
        raise ValueError(f"{name}: every tensor must be contiguous and on {q.device}")
    fn = _kernels()[name]
    rate = cfg.dropout_rate
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                 B, Hq, Hkv, T, S, D, int(cfg.causal),
                 -1 if cfg.window is None else int(cfg.window), _scale(D),
                 dropout_threshold(rate), float(1.0 - rate), int(rate > 0.0),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")


def flash_fwd(q, k, v, segment_ids, seed, cfg: "FlashCfg"):
    """Forward kernel (CUDA) or its plain version (CPU): (O, LSE)."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, segment_ids, seed, cfg)
    B, Hq, T, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    _launch("glm_flash_fwd", [q, k, v, segment_ids, seed, out, lse], q, k, cfg)
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, segment_ids, seed, dout, lse, delta, cfg: "FlashCfg"):
    """dQ kernel (CUDA) or its plain version (CPU)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, segment_ids, seed, dout, lse, delta, cfg)
    dq = torch.empty_like(q)
    _launch("glm_flash_bwd_dq", [q, k, v, segment_ids, seed, dout, lse, delta, dq], q, k, cfg)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, segment_ids, seed, dout, lse, delta, cfg: "FlashCfg"):
    """dK/dV kernel (CUDA) or its plain version (CPU), reduced over each kv
    head's query group."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, segment_ids, seed, dout, lse, delta, cfg)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("glm_flash_bwd_dkv", [q, k, v, segment_ids, seed, dout, lse, delta, dk, dv],
            q, k, cfg)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class FlashCfg(NamedTuple):
    """The static arguments of one call (the JAX ``_FlashConfig``)."""

    causal: bool
    window: int | None
    dropout_rate: float


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, seed, cfg):
        out, lse = flash_fwd(q, k, v, segment_ids, seed, cfg)
        ctx.save_for_backward(q, k, v, segment_ids, seed, out, lse)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, seed, out, lse = ctx.saved_tensors
        cfg = ctx.cfg
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, segment_ids, seed, dout, lse, delta, cfg)
        dk, dv = flash_bwd_dkv(q, k, v, segment_ids, seed, dout, lse, delta, cfg)
        return dq, dk, dv, None, None, None


def _check_args(q, k, v, segment_ids, seed, dropout_rate):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Hq, T, D) and k, v (B, Hkv, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, T, D = q.shape
    Bk, Hkv, S, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if S < T:
        raise ValueError(f"key length {S} shorter than query length {T}")
    if Hkv < 1 or Hq % Hkv != 0:
        raise ValueError("n_head must be divisible by n_kv_head")
    if q.dtype not in _FLOAT_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one float dtype; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if segment_ids is not None and (tuple(segment_ids.shape) != (B, S)
                                    or segment_ids.dtype != torch.int32):
        raise ValueError(f"segment_ids must be int32 (B, S) = ({B}, {S})")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if dropout_rate > 0.0 and (seed is None or seed.numel() != 1
                               or seed.dtype != torch.int32):
        raise ValueError("dropout needs a one-element int32 seed tensor")
    tensors = [t for t in (q, k, v, segment_ids, seed) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all flash_attention inputs must be on one device")
    if q.device.type == "cuda":
        if q.dtype not in _DTYPE_CODES:
            raise ValueError(f"the kernels take float32 or bfloat16, got {q.dtype}")
        if D > KERNEL_MAX_HEAD_DIM:
            raise ValueError(f"kernel takes head_dim <= {KERNEL_MAX_HEAD_DIM}, got {D}")
        if B > 65535 or Hq > 65535:
            raise ValueError(f"kernel takes B and Hq <= 65535, got {B}, {Hq}")
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda (kernels) or cpu (plain "
                         f"versions), not {q.device.type}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    segment_ids: torch.Tensor | None = None,
    attention_window: int | None = None,
    dropout_rate: float = 0.0,
    seed: torch.Tensor | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Flash attention with the framework's structured masks; differentiable.

    q: (B, Hq, T, D); k, v: (B, Hkv, S, D) in q's dtype; segment_ids: (B, S)
    int32 (query segments are the trailing T entries). With T < S the
    queries are the suffix of the keys. ``seed``: a one-element int32 tensor
    on q's device; dropout acts only when it is given and the rate is > 0,
    as the JAX function drops only with a key. Returns (B, Hq, T, D) in
    q's dtype.
    """
    use_dropout = dropout_rate > 0.0 and seed is not None
    rate = float(dropout_rate) if use_dropout else 0.0
    _check_args(q, k, v, segment_ids, seed if use_dropout else None, rate)
    cfg = FlashCfg(bool(causal), None if attention_window is None else int(attention_window),
                   rate)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if segment_ids is not None:
        segment_ids = segment_ids.contiguous()
    return _Flash.apply(q, k, v, segment_ids, seed if use_dropout else None, cfg)


__all__ = [
    "dropout_threshold",
    "FlashCfg",
    "flash_attention",
    "flash_bwd_dkv",
    "flash_bwd_dkv_reference",
    "flash_bwd_dq",
    "flash_bwd_dq_reference",
    "flash_forward_reference",
    "flash_fwd",
    "philox4x32_10",
    "philox_keep",
]
