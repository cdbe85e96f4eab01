"""Decode attention: the port's wrappers against the JAX Pallas kernels.

On the CPU the port's ``decode_attention``, ``decode_attention_chunk`` and
``decode_attention_streamed`` run their plain versions; the JAX kernels
run in Pallas interpret mode (as ``tests/test_decode_attention.py`` and
``tests/test_speculative.py`` run them) and beside them the JAX einsum
references. The same numpy inputs go to all; float32, tolerance 1e-5 for
the single-token op and 2e-6 for the chunk and streamed ops (both sides
accumulate in f32, in different orders). The tests of the CUDA kernels
themselves need the card: they are in ``tests/test_torch_cuda.py``.
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
    CHUNK_TILE,
    NEG_INF,
    chunk_live_tiles,
    decode_attention,
    decode_attention_chunk,
    decode_attention_reference,
    decode_attention_streamed,
    decode_attention_streamed_reference,
    decode_live_tiles,
    stream_block_s,
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
    """A library's name carries the hash of its source and the shared
    headers, so an edited source or header rebuilds; without nvcc a build
    raises instead of loading anything."""
    from genomics_lm_torch.kernels import build as kb

    lib = kb.library_path("decode_attention")
    assert lib.parent == kb.BUILD_DIR and lib.suffix == ".so"
    assert lib.name.startswith("libdecode_attention-")
    assert kb.library_path("decode_attention") == lib
    (tmp_path / "decode_attention.cu").write_text("// another source\n")
    monkeypatch.setattr(kb, "CSRC", tmp_path)
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path / "_build")
    edited = kb.library_path("decode_attention").name
    assert edited != lib.name
    (tmp_path / "decode_common.cuh").write_text("// a shared header\n")
    assert kb.library_path("decode_attention").name != edited  # headers count too
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kb.build(["decode_attention"])


# --- the verify-chunk op (kernel row 6) and the streamed op (kernel row 5) ------

KERNEL_ATOL = 2e-6  # float32 on both sides; only the order of the sums differs


def make_chunk_inputs(rng, B, Hkv, G, T, S_, quant):
    """Packed caches, (B, Hq, T, D) query and a (B, T, S) mask with an
    intra-chunk staircase and, in slot 1, a segment gap."""
    L_, D_ = 3, 48
    kh = rng.normal(size=(L_, B, Hkv, S_, D_)).astype(np.float32)
    vh = rng.normal(size=(L_, B, Hkv, S_, D_)).astype(np.float32)
    ks = vs = None
    if quant:
        kh, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(kh)))
        vh, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(vh)))
    pack = lambda a: np.ascontiguousarray(  # noqa: E731
        a.transpose(0, 1, 3, 2, 4).reshape(L_, B, S_, Hkv * D_))
    q = rng.normal(size=(B, Hkv * G, T, D_)).astype(np.float32)
    mask = np.zeros((B, T, S_), np.float32)
    for t in range(T):
        mask[:, t, S_ // 2 + t + 1:] = -1e30
    mask[1, :, 5:20] = -1e30
    return q, pack(kh), pack(vh), mask, ks, vs


@pytest.mark.parametrize("G,quant", [(1, False), (2, False), (2, True)],
                         ids=["g1", "g2", "g2_int8"])
def test_chunk_matches_jax_kernel_and_reference(G, quant):
    """The chunk op's plain version against JAX ``decode_attention_chunk``
    (Pallas interpret mode) and ``decode_attention_chunk_xla``: float32,
    tolerance 2e-6."""
    rng = np.random.default_rng(20 + G + quant)
    Hkv, T = 2, 4
    q, k, v, mask, ks, vs = make_chunk_inputs(rng, 5, Hkv, G, T, 64, quant)
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    jscales = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    for layer in (0, 2):
        want_kernel = np.asarray(jax_da.decode_attention_chunk(
            *jargs, layer, *jscales, kv_heads=Hkv, interpret=True))
        want_xla = np.asarray(jax_da.decode_attention_chunk_xla(
            *jargs, layer, *jscales, kv_heads=Hkv))
        got = decode_attention_chunk(*to_torch(q, k, v, mask), layer, *to_torch(ks, vs),
                                     kv_heads=Hkv)
        assert got.dtype == torch.float32 and got.shape == (5, Hkv * G, T, 48)
        np.testing.assert_allclose(got.numpy(), want_kernel, atol=KERNEL_ATOL)
        np.testing.assert_allclose(got.numpy(), want_xla, atol=KERNEL_ATOL)


def test_chunk_row_equals_single_token_op():
    """A chunk of one query is the single-token op on the same mask row."""
    rng = np.random.default_rng(27)
    q, k, v, mask, ks, vs = to_torch(*make_chunk_inputs(rng, 3, 2, 2, 1, 40, True))
    got = decode_attention_chunk(q, k, v, mask, 1, ks, vs, kv_heads=2)
    want = decode_attention(q[:, :, 0].contiguous(), k, v, mask[:, 0].contiguous(), 1,
                            ks, vs, kv_heads=2)
    np.testing.assert_allclose(got[:, :, 0].numpy(), want.numpy(), atol=KERNEL_ATOL)


@pytest.mark.parametrize("block_s,first_masked",
                         [(None, False), (32, False), (16, False), (16, True)],
                         ids=["default", "bs32", "bs16", "bs16_first_chunk_masked"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_streamed_matches_jax_kernel_and_reference(block_s, first_masked, quant):
    """The streamed op's plain version (JAX's online-softmax recurrence over
    chunks of ``block_s``) against JAX ``decode_attention_streamed`` in
    Pallas interpret mode and ``decode_attention_xla``: float32, 2e-6."""
    rng = np.random.default_rng(40 + (block_s or 0) + first_masked + 2 * quant)
    B, Hkv, G = 4, 2, 2
    q, k, v, mask, ks, vs = make_inputs(rng, B, Hkv, G, quant)
    if first_masked:
        mask[:, :block_s] = -1e30  # every row's whole first chunk is blocked
        mask[:, S - 1] = 0.0
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    jscales = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    for layer in (0, L - 1):
        want_kernel = np.asarray(jax_da.decode_attention_streamed(
            *jargs, layer, *jscales, kv_heads=Hkv, block_s=block_s, interpret=True))
        want_xla = np.asarray(jax_da.decode_attention_xla(
            *jargs, layer, *jscales, kv_heads=Hkv))
        got = decode_attention_streamed(*to_torch(q, k, v, mask), layer, *to_torch(ks, vs),
                                        kv_heads=Hkv, block_s=block_s)
        assert got.dtype == torch.float32 and got.shape == (B, Hkv * G, D)
        np.testing.assert_allclose(got.numpy(), want_kernel, atol=KERNEL_ATOL)
        np.testing.assert_allclose(got.numpy(), want_xla, atol=KERNEL_ATOL)


# verify masks as serving/speculative.py builds them (S 160: tiles [0, 64),
# [64, 128) and the ragged [128, 160); T 5): per slot its length, and the
# cache positions [lo, hi) that hold another segment
SPEC_S, SPEC_T = 160, 5
MASK_SCENARIOS = {
    "staircase": ([3, 40, 70, 100], None),
    # slot 0's positions 60..131 belong to another segment: tile 1 wholly masked
    "segment_gap": ([140, 20, 90, 10], (60, 132)),
    # length + t past S - 1: the chunk's rows are written at S - 1
    "clamped_self_pos": ([SPEC_S - 2, SPEC_S - 3, 50, SPEC_S - 1], None),
    "empty_slot": ([0, 0, 30, 5], None),
    # the chunk fills the cache exactly; chunks that start or end a tile
    "full_slot": ([SPEC_S - SPEC_T, 64, 128, 59], None),
}


def spec_mask(lengths, other_segment):
    """(B, T, S) mask from ``speculative.verify_mask`` after the chunk's
    segment ids are written at their clamped positions, as ``_ragged_verify``
    does."""
    from genomics_lm_torch.serving.speculative import verify_mask

    B = len(lengths)
    lengths = torch.tensor(lengths)
    seg = torch.zeros((B, SPEC_S), dtype=torch.int32)
    if other_segment:
        seg[0, other_segment[0]:other_segment[1]] = 7
    wpos = (lengths[:, None] + torch.arange(SPEC_T)[None, :]).clamp_max(SPEC_S - 1)
    chunk_seg = torch.zeros((B, SPEC_T), dtype=torch.int32)
    seg[torch.arange(B)[:, None], wpos] = chunk_seg
    return verify_mask(seg, lengths, chunk_seg, wpos)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("scenario", list(MASK_SCENARIOS))
def test_chunk_live_tiles_drop_only_masked_positions(scenario, quant):
    """The bf16 chunk kernel's tile rule on verify masks: every entry of a
    dead tile is <= NEG_INF/2 in every row, every live tile holds an entry
    above it, and the plain version with the dead tiles' K and V (and int8
    scales) overwritten by large finite values is unchanged within 1e-6."""
    lengths, other = MASK_SCENARIOS[scenario]
    mask = spec_mask(lengths, other)
    B, Hkv, G = len(lengths), 2, 2
    live = chunk_live_tiles(mask)
    assert live.shape == (B, 3) and live.dtype == torch.bool
    for b in range(B):
        for t in range(3):
            tile = mask[b, :, 64 * t:64 * (t + 1)]
            assert bool((tile > 0.5 * NEG_INF).any()) == bool(live[b, t])
    assert not bool(live.all()) or scenario == "full_slot"
    if scenario == "segment_gap":
        assert live[0].tolist() == [True, False, True]
    if scenario == "empty_slot":
        assert live[0].tolist() == [True, False, False]
    if scenario == "full_slot":
        assert bool(live[0].all()) and live[1].tolist() == [True, True, False]
        assert live[3].tolist() == [True, False, False]  # rows end at position 63

    rng = np.random.default_rng(50 + len(scenario) + quant)
    q, k, v, _, ks, vs = make_chunk_inputs(rng, B, Hkv, G, SPEC_T, SPEC_S, quant)
    args = to_torch(q, k, v, mask.numpy(), ks, vs)
    want = decode_attention_chunk(*args[:4], 1, *args[4:], kv_heads=Hkv)
    dead = ~live.repeat_interleave(64, 1)[:, :SPEC_S]  # (B, S)
    k2, v2 = args[1].clone(), args[2].clone()
    if quant:
        noise = torch.from_numpy(rng.integers(-127, 128, k2.shape).astype(np.int8))
        k2[:, dead], v2[:, dead] = noise[:, dead], noise.flip(0)[:, dead]
        ks2, vs2 = args[4].clone(), args[5].clone()
        big = torch.from_numpy(rng.uniform(1e2, 1e3, ks2.shape).astype(np.float32))
        ks2[:, dead[:, None, :].expand(B, Hkv, SPEC_S)] = big[:, dead[:, None, :].expand(
            B, Hkv, SPEC_S)]
        vs2[:, dead[:, None, :].expand(B, Hkv, SPEC_S)] = big[:, dead[:, None, :].expand(
            B, Hkv, SPEC_S)]
        scales = (ks2, vs2)
    else:
        noise = torch.from_numpy(rng.normal(0.0, 1e3, k2.shape).astype(np.float32))
        k2[:, dead], v2[:, dead] = noise[:, dead], -noise[:, dead]
        scales = (None, None)
    got = decode_attention_chunk(args[0], k2, v2, args[3], 1, *scales, kv_heads=Hkv)
    assert not torch.equal(k2, args[1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# single-token masks as the engine builds them (generation/decode.py::_decode_mask;
# S 160: tiles [0, 64), [64, 128) and the ragged [128, 160)): per slot its
# length and the position where its current segment starts
DEC_S = 160
DECODE_SCENARIOS = {
    # slot 0's segment starts at 70 (tile 0 dead), slot 1's at 130 (tiles 0-1 dead)
    "segment_gap": ([150, 155, 90, 20], [70, 130, 0, 0]),
    "empty_tail": ([5, 63, 64, 100], [0, 0, 0, 0]),
    # every position filled: the write position clamps to S - 1
    "full_slot": ([DEC_S, DEC_S - 1, 127, 128], [0, 0, 0, 0]),
}


def decode_mask(lengths, seg_starts):
    """(B, S) mask from ``_decode_mask``: cache positions at or after a
    slot's segment start hold its current segment (1), those before it an
    earlier one (0)."""
    from genomics_lm_torch.generation.decode import _decode_mask

    lengths = torch.tensor(lengths)
    seg = (torch.arange(DEC_S)[None, :] >= torch.tensor(seg_starts)[:, None]).to(torch.int32)
    return _decode_mask(seg, torch.ones(len(lengths), dtype=torch.int32), lengths[:, None],
                        lengths.clamp_max(DEC_S - 1)[:, None], 3)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("scenario", list(DECODE_SCENARIOS))
def test_decode_live_tiles_drop_only_masked_positions(scenario, quant):
    """The single-token kernels' tile rule on decode masks: a tile is live
    when some entry of it is above NEG_INF/2; the plain versions of the
    single-pass and the streamed op with the dead tiles' K and V (and int8
    scales) overwritten by large finite values are unchanged within 1e-6."""
    mask = decode_mask(*DECODE_SCENARIOS[scenario])
    B, Hkv, G = mask.shape[0], 2, 2
    live = decode_live_tiles(mask)
    assert live.shape == (B, 3) and live.dtype == torch.bool
    for b in range(B):
        for t in range(3):
            assert bool((mask[b, 64 * t:64 * (t + 1)] > 0.5 * NEG_INF).any()) == bool(live[b, t])
    want_live = {
        "segment_gap": [[False, True, True], [False, False, True], [True, True, False],
                        [True, False, False]],
        "empty_tail": [[True, False, False], [True, False, False], [True, True, False],
                       [True, True, False]],
        "full_slot": [[True, True, True], [True, True, True], [True, True, False],
                      [True, True, True]],
    }[scenario]
    assert live.tolist() == want_live

    rng = np.random.default_rng(60 + len(scenario) + quant)
    L_ = 2
    kh = rng.normal(size=(L_, B, Hkv, DEC_S, D)).astype(np.float32)
    vh = rng.normal(size=(L_, B, Hkv, DEC_S, D)).astype(np.float32)
    ks = vs = None
    if quant:
        kh, ks = (torch.from_numpy(np.array(a)) for a in jax_quantize_kv(jnp.asarray(kh)))
        vh, vs = (torch.from_numpy(np.array(a)) for a in jax_quantize_kv(jnp.asarray(vh)))
    else:
        kh, vh = torch.from_numpy(kh), torch.from_numpy(vh)
    k, v = (a.transpose(2, 3).reshape(L_, B, DEC_S, Hkv * D).contiguous() for a in (kh, vh))
    q = torch.from_numpy(rng.normal(size=(B, Hkv * G, D)).astype(np.float32))
    dead = ~live.repeat_interleave(64, 1)[:, :DEC_S]  # (B, S)
    k2, v2 = k.clone(), v.clone()
    ks2 = vs2 = None
    if quant:
        noise = torch.from_numpy(rng.integers(-127, 128, k2.shape).astype(np.int8))
        k2[:, dead], v2[:, dead] = noise[:, dead], noise.flip(0)[:, dead]
        sd = dead[:, None, :].expand(B, Hkv, DEC_S)
        big = torch.from_numpy(rng.uniform(1e2, 1e3, ks.shape).astype(np.float32))
        ks2, vs2 = ks.clone(), vs.clone()
        ks2[:, sd], vs2[:, sd] = big[:, sd], big.flip(0)[:, sd]
    else:
        noise = torch.from_numpy(rng.normal(0.0, 1e3, k2.shape).astype(np.float32))
        k2[:, dead], v2[:, dead] = noise[:, dead], -noise[:, dead]
    assert not torch.equal(k2, k)
    for op in (decode_attention, decode_attention_streamed_reference):
        want = op(q, k, v, mask, 1, ks, vs, kv_heads=Hkv)
        got = op(q, k2, v2, mask, 1, ks2, vs2, kv_heads=Hkv)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_streamed_middle_split_without_live_position(quant):
    """A split with no live position between two live ones adds exactly
    nothing: the streamed op's plain version against JAX
    ``decode_attention_streamed`` (Pallas interpret mode) and
    ``decode_attention_xla``, float32, 2e-6."""
    rng = np.random.default_rng(48 + quant)
    B, Hkv, G, block_s = 4, 2, 2, 16
    q, k, v, mask, ks, vs = make_inputs(rng, B, Hkv, G, quant)
    mask[:, :block_s] = 0.0
    mask[:, block_s:2 * block_s] = -1e30  # every row's whole second split
    mask[:, 2 * block_s] = 0.0
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    jscales = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    want_kernel = np.asarray(jax_da.decode_attention_streamed(
        *jargs, 1, *jscales, kv_heads=Hkv, block_s=block_s, interpret=True))
    want_xla = np.asarray(jax_da.decode_attention_xla(*jargs, 1, *jscales, kv_heads=Hkv))
    got = decode_attention_streamed(*to_torch(q, k, v, mask), 1, *to_torch(ks, vs),
                                    kv_heads=Hkv, block_s=block_s)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=KERNEL_ATOL)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=KERNEL_ATOL)


def test_streamed_ragged_last_chunk_matches_single_pass():
    """A ``block_s`` that does not divide S keeps the ragged last chunk."""
    rng = np.random.default_rng(46)
    args = to_torch(*make_inputs(rng, 3, 2, 1, True))
    got = decode_attention_streamed(*args[:4], 1, *args[4:], kv_heads=2, block_s=24)
    want = decode_attention(*args[:4], 1, *args[4:], kv_heads=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=KERNEL_ATOL)


def test_stream_block_s_splits_small_batches_only():
    """The streamed kernel's default split: none once the batch fills the
    card's resident blocks (4 a SM), whole 64-position tiles below that (so
    a split reads the cache's own tiles), never more than S."""
    assert stream_block_s(256, 8, 256, 132) == 256
    assert stream_block_s(64, 8, 256, 132) == 256  # 512 blocks: one wave of 4 x 132 already
    assert stream_block_s(32, 8, 256, 132) == 128  # 2 splits
    assert stream_block_s(32, 8, 384, 132) == 192  # 2 splits of 3 tiles
    assert stream_block_s(16, 8, 256, 132) == 64  # 4 splits of one tile
    assert stream_block_s(1, 1, 256, 132) == 64
    assert stream_block_s(1, 1, 20, 132) == 20
    assert stream_block_s(1, 1, 130, 132) == 64  # the last split ragged
    for B in (1, 5, 64, 256):
        bs = stream_block_s(B, 8, 384, 132)
        assert 64 <= bs <= 384 and (bs % CHUNK_TILE == 0 or bs == 384)


def test_chunk_and_streamed_wrappers_check_contract():
    rng = np.random.default_rng(47)
    q, k, v, mask, ks, vs = to_torch(*make_chunk_inputs(rng, 2, 2, 1, 3, 32, True))
    with pytest.raises(ValueError, match="mask_add"):
        decode_attention_chunk(q, k, v, mask[:, 0].contiguous(), 0, ks, vs)
    with pytest.raises(ValueError, match="T, D"):
        decode_attention_chunk(q[:, :, 0].contiguous(), k, v, mask, 0, ks, vs)
    with pytest.raises(ValueError, match="layer"):
        decode_attention_chunk(q, k, v, mask, 3, ks, vs)
    q1, k1, v1, m1, ks1, vs1 = to_torch(*make_inputs(rng, 2, 2, 1, True))
    with pytest.raises(ValueError, match="block_s"):
        decode_attention_streamed(q1, k1, v1, m1, 0, ks1, vs1, block_s=0)
    with pytest.raises(ValueError, match="together"):
        decode_attention_streamed(q1, k1, v1, m1, 0, ks1, None)
    meta = [t.to("meta") for t in to_torch(*make_chunk_inputs(rng, 2, 2, 1, 3, 32,
                                                                False)[:4])]
    before = decode_attention_chunk.launches
    with pytest.raises(ValueError, match="not meta"):
        decode_attention_chunk(*meta, 0, kv_heads=2)
    assert decode_attention_chunk.launches == before
    meta1 = [t.to("meta") for t in to_torch(*make_inputs(rng, 2, 2, 1, False)[:4])]
    before = decode_attention_streamed.launches
    with pytest.raises(ValueError, match="not meta"):
        decode_attention_streamed(*meta1, 0, kv_heads=2)
    assert decode_attention_streamed.launches == before


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_chunk_bound_counts_only_the_positions_needed(quant):
    """``decode_bound_ms`` with ``positions``: every position is the default;
    fewer positions drop their cache (and scale) bytes and operations, while
    the query, the whole mask and the output are still counted."""
    from genomics_lm_torch.utils.timing import decode_bound_ms

    B, S, Hkv, G, D, T = 4, 384, 8, 1, 48, 5
    esize = 1 if quant else 2
    args = (B, S, Hkv, G, D, esize, 2, quant, 3.35e12, 989e12)
    full = decode_bound_ms(*args, T=T)
    assert decode_bound_ms(*args, T=T, positions=B * S) == full
    ms, by, nbytes = decode_bound_ms(*args, T=T, positions=100)
    fixed = B * Hkv * G * T * D * (2 + 4) + B * T * S * 4  # query, output, mask
    per_pos = 2 * Hkv * D * esize + (2 * Hkv * 4 if quant else 0)
    assert full[2] == fixed + B * S * per_pos and nbytes == fixed + 100 * per_pos
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_benchmark_inputs_follow_the_decode_contract(kv_quant):
    """``benchmark_decode_kernel``'s inputs pass the ops' checks, and the
    blocked and streamed ops agree on them (plain versions on the CPU)."""
    from genomics_lm_torch.serving import benchmark_decode_kernel as bench

    args = bench.parse_args(["--n_layer", "2", "--batch_size", "3", "--cache_slots", "40",
                             "--n_head", "4", "--kv_heads", "2"] + ["--kv_quant"] * kv_quant)
    q, k, v, mask, ks, vs = bench.make_inputs(args, device="cpu")
    assert k.shape == (2, 3, 40, 2 * 48) and k.dtype == (torch.int8 if kv_quant
                                                         else torch.bfloat16)
    assert (ks is not None) == kv_quant and bool((mask[:, :10] == 0).all())
    blocked = decode_attention(q, k, v, mask, 1, ks, vs, kv_heads=2)
    streamed = decode_attention_streamed(q, k, v, mask, 1, ks, vs, kv_heads=2, block_s=16)
    np.testing.assert_allclose(streamed.numpy(), blocked.numpy(), atol=KERNEL_ATOL)
