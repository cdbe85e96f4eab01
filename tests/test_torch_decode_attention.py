"""Decode attention: the port's wrapper against the JAX Pallas kernel.

On the CPU the port's ``decode_attention`` runs its plain version; the
JAX kernel runs in Pallas interpret mode (as ``tests/test_decode_attention.py``
runs it) and beside it the JAX einsum reference ``decode_attention_xla``.
The same numpy inputs go to all three; float32, tolerance 1e-5 (both sides
accumulate in f32, in different orders). The test of the CUDA kernel
itself needs the card: it is in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.ops import decode_attention as jax_da
from genomics_lm_tpu.ops.quant import quantize_kv as jax_quantize_kv
from genomics_lm_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from genomics_lm_torch.ops.quant import quantize_kv

ATOL = 1e-5
L, S, D = 2, 64, 16


def make_inputs(rng, B, Hkv, G, quant):
    """Packed (L, B, S, Hkv·D) caches, (B, Hq, D) query, ragged (B, S) mask."""
    kh = rng.normal(size=(L, B, Hkv, S, D)).astype(np.float32)
    vh = rng.normal(size=(L, B, Hkv, S, D)).astype(np.float32)
    ks = vs = None
    if quant:
        kh, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(kh)))
        vh, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(vh)))
    pack = lambda a: np.ascontiguousarray(  # noqa: E731
        a.transpose(0, 1, 3, 2, 4).reshape(L, B, S, Hkv * D))
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, B)
    mask = np.where(np.arange(S)[None, :] < lengths[:, None], 0.0, -1e30)
    mask[0, : S // 4] = -1e30  # a segment boundary in row 0
    mask[0, S // 2] = 0.0
    return q, pack(kh), pack(vh), mask.astype(np.float32), ks, vs


def to_torch(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 8, 16])
def test_matches_jax_kernel_and_reference(B, G, quant):
    rng = np.random.default_rng(100 * B + 10 * G + quant)
    Hkv = 2
    q, k, v, mask, ks, vs = make_inputs(rng, B, Hkv, G, quant)
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    jscales = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    for layer in (0, L - 1):
        want_kernel = np.asarray(jax_da.decode_attention(
            *jargs, layer, *jscales, kv_heads=Hkv, interpret=True))
        want_xla = np.asarray(jax_da.decode_attention_xla(
            *jargs, layer, *jscales, kv_heads=Hkv))
        got = decode_attention(*to_torch(q, k, v, mask), layer, *to_torch(ks, vs),
                               kv_heads=Hkv)
        assert got.dtype == torch.float32 and got.shape == (B, Hkv * G, D)
        np.testing.assert_allclose(got.numpy(), want_kernel, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL)


def test_single_valid_slot_returns_that_v_row():
    rng = np.random.default_rng(2)
    B, Hkv = 4, 2
    q, k, v, _, _, _ = make_inputs(rng, B, Hkv, 1, False)
    mask = np.full((B, S), -1e30, np.float32)
    mask[:, 7] = 0.0
    got = decode_attention(*to_torch(q, k, v, mask), 0, kv_heads=Hkv)
    np.testing.assert_allclose(got.numpy(), v[0, :, 7, :].reshape(B, Hkv, D), atol=ATOL)


def test_reference_bf16_compute_matches_jax_reference():
    rng = np.random.default_rng(3)
    q, k, v, mask, _, _ = make_inputs(rng, 8, 2, 2, False)
    want = np.asarray(jax_da.decode_attention_xla(
        *(jnp.asarray(a) for a in (q, k, v, mask)), 1,
        compute_dtype=jnp.bfloat16, kv_heads=2))
    got = decode_attention_reference(*to_torch(q, k, v, mask), 1,
                                      compute_dtype=torch.bfloat16, kv_heads=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(4).normal(size=(3, 5, 16)).astype(np.float32)
    want_q, want_s = jax_quantize_kv(jnp.asarray(x))
    got_q, got_s = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_wrapper_checks_contract():
    rng = np.random.default_rng(5)
    q, k, v, mask, ks, vs = to_torch(*make_inputs(rng, 4, 2, 2, True))
    with pytest.raises(ValueError, match="mask_add"):
        decode_attention(q, k, v, mask.double(), 0, ks, vs)
    with pytest.raises(ValueError, match="together"):
        decode_attention(q, k, v, mask, 0, ks, None)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, mask, 0,
                         ks, vs)
    with pytest.raises(ValueError, match="layer"):
        decode_attention(q, k, v, mask, L, ks, vs)
    with pytest.raises(ValueError, match="needs k_scale"):
        decode_attention(q, k, v, mask, 0, kv_heads=2)
    with pytest.raises(ValueError, match="does not fit"):
        decode_attention(q, k, v, mask, 0, ks, vs, kv_heads=4)


def test_wrapper_raises_off_cpu_and_cuda():
    """No hidden fallback: a tensor on another device never reaches the plain path."""
    rng = np.random.default_rng(6)
    args = [t.to("meta") for t in to_torch(*make_inputs(rng, 2, 2, 1, False)[:4])]
    before = decode_attention.launches
    with pytest.raises(ValueError, match="not meta"):
        decode_attention(*args, 0, kv_heads=2)
    assert decode_attention.launches == before


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    """A library's name carries the hash of its source, so an edited source
    rebuilds; without nvcc a build raises instead of loading anything."""
    from genomics_lm_torch.kernels import build as kb

    lib = kb.library_path("decode_attention")
    assert lib.parent == kb.BUILD_DIR and lib.suffix == ".so"
    assert lib.name.startswith("libdecode_attention-")
    assert kb.library_path("decode_attention") == lib
    (tmp_path / "decode_attention.cu").write_text("// another source\n")
    monkeypatch.setattr(kb, "CSRC", tmp_path)
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path / "_build")
    assert kb.library_path("decode_attention").name != lib.name
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kb.build(["decode_attention"])
