"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and carry the ``cuda`` marker; without a
card they skip. This file imports neither JAX nor the JAX package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX.) Inputs come from
numpy with a seed. Tolerances: 1e-5 (decode, float32) or 1e-4 (flash,
float32) where only the order of float32 sums differs; 1e-3 and 2e-2 of
the largest entry in bf16, where outputs may round to neighbouring bf16
values.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from genomics_lm_torch.ops import flash_attention as fa
from genomics_lm_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from genomics_lm_torch.ops.quant import quantize_kv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def decode_inputs(rng, B, Hkv, G, quant, L=2, S=64, D=16):
    """Packed (L, B, S, Hkv·D) caches, (B, Hq, D) query, ragged (B, S) mask."""
    kh = torch.from_numpy(rng.normal(size=(L, B, Hkv, S, D)).astype(np.float32))
    vh = torch.from_numpy(rng.normal(size=(L, B, Hkv, S, D)).astype(np.float32))
    ks = vs = None
    if quant:
        kh, ks = quantize_kv(kh)
        vh, vs = quantize_kv(vh)
    pack = lambda a: a.transpose(2, 3).reshape(L, B, S, Hkv * D).contiguous()  # noqa: E731
    q = torch.from_numpy(rng.normal(size=(B, Hkv * G, D)).astype(np.float32))
    lengths = rng.integers(1, S + 1, B)
    mask = np.where(np.arange(S)[None, :] < lengths[:, None], 0.0, -1e30)
    mask[0, : S // 4] = -1e30  # a segment boundary in row 0
    mask[0, S // 2] = 0.0
    return q, pack(kh), pack(vh), torch.from_numpy(mask.astype(np.float32)), ks, vs


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda):
    """The decode kernel on the card against its plain version (f32, bf16, int8)."""
    rng = np.random.default_rng(7)
    for quant, dtype, tol in ((False, torch.float32, 1e-5),
                              (False, torch.bfloat16, 1e-3),
                              (True, torch.bfloat16, 1e-3)):
        q, k, v, mask, ks, vs = decode_inputs(rng, 8, 2, 4, quant)
        q = q.to(dtype)
        if not quant:
            k, v = k.to(dtype), v.to(dtype)
        dev = [None if t is None else t.to(cuda) for t in (q, k, v, mask, ks, vs)]
        got = decode_attention(*dev[:4], 1, *dev[4:], kv_heads=2)
        want = decode_attention_reference(*dev[:4], 1, *dev[4:], kv_heads=2)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    """The three flash kernels on the card against their plain versions,
    with dropout, segments, a window, GQA and ragged lengths."""
    rng = np.random.default_rng(8)
    for (B, Hq, Hkv, T, S, D, window), dtype, tol in (
            ((2, 2, 1, 64, 64, 16, 21), torch.float32, 1e-4),
            ((2, 2, 2, 76, 130, 16, None), torch.bfloat16, 2e-2)):
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(cuda, dtype) for shape in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D)))
        seps = (torch.arange(S) % 17 == 0).int()
        seg = torch.cumsum(seps[None].expand(B, S), -1, dtype=torch.int32).to(cuda)
        seed = torch.tensor([3], dtype=torch.int32, device=cuda)
        cfg = fa.FlashCfg(True, window, 0.1)
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*args, segment_ids=seg, attention_window=window,
                                 dropout_rate=0.1, seed=seed)
        cot = torch.randn_like(out)
        grads = torch.autograd.grad(out, args, cot)
        ref, lse = fa.flash_forward_reference(q, k, v, seg, seed, cfg)
        delta = (cot.float() * out.detach().float()).sum(-1)
        ref_grads = (fa.flash_bwd_dq_reference(q, k, v, seg, seed, cot, lse, delta, cfg),
                     *fa.flash_bwd_dkv_reference(q, k, v, seg, seed, cot, lse, delta, cfg))
        torch.cuda.synchronize()
        for got, want in zip((out.detach(), *grads), (ref, *ref_grads)):
            scale = max(1.0, float(want.float().abs().max()))
            assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_cuda_flash_refuses_float16(cuda):
    """The flash kernels exist in float32 and bfloat16 only: float16 on the
    card raises before any launch instead of taking the plain version."""
    q = torch.zeros((1, 2, 16, 16), dtype=torch.float16, device=cuda)
    before = fa.flash_fwd.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    assert fa.flash_fwd.launches == before
