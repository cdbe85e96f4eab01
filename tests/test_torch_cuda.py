"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and carry the ``cuda`` marker; without a
card they skip. This file imports neither JAX nor the JAX package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX.) Inputs come from
numpy with a seed. Tolerances: 1e-5 (decode, chunk and streamed, float32)
or 1e-4 (flash, float32) where only the order of float32 sums differs;
1e-3 (decode and streamed, bf16) and 2e-2 of the largest entry (flash,
bf16), where outputs may round to neighbouring bf16 values and the bf16
flash kernels round P and dS to bf16 before their second product; for the
bf16 chunk kernel, which rounds P to bf16 before P.V, a bound per output
element (``chunk_bf16_bound``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from genomics_lm_torch.ops import flash_attention as fa
from genomics_lm_torch.ops.decode_attention import (
    KERNEL_MAX_CHUNK_ROWS,
    chunk_live_tiles,
    decode_attention,
    decode_attention_chunk,
    decode_attention_chunk_reference,
    decode_attention_reference,
    decode_attention_streamed,
    decode_attention_streamed_reference,
    decode_live_tiles,
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
    with dropout, segments, a window, GQA and ragged lengths; in bf16 also
    the tensor-core kernels' failure modes: a segment every 4 tokens at
    dropout 0.5 (a wrong keep bit or skipped tile moves an output far),
    random non-monotone ids, padded head widths (20, 64, 128) and GQA 4:1
    with a window off the grid."""
    rng = np.random.default_rng(8)
    bf16 = torch.bfloat16
    for (B, Hq, Hkv, T, S, D, window), segs, rate, dtype, tol in (
            ((2, 2, 1, 64, 64, 16, 21), 17, 0.1, torch.float32, 1e-4),
            ((2, 2, 2, 76, 130, 16, None), 17, 0.1, bf16, 2e-2),
            ((2, 2, 2, 256, 256, 48, None), 4, 0.5, bf16, 2e-2),
            ((2, 2, 2, 192, 192, 48, None), "random", 0.1, bf16, 2e-2),
            ((2, 2, 2, 100, 100, 20, None), 17, 0.1, bf16, 2e-2),
            ((2, 2, 2, 100, 100, 64, None), 17, 0.1, bf16, 2e-2),
            ((2, 2, 2, 100, 100, 128, None), 17, 0.1, bf16, 2e-2),
            ((2, 8, 2, 130, 333, 48, 50), 17, 0.1, bf16, 2e-2)):
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(cuda, dtype) for shape in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D)))
        if segs == "random":
            seg = torch.from_numpy(rng.integers(0, 4, (B, S)).astype(np.int32)).to(cuda)
        else:
            seps = (torch.arange(S) % segs == 0).int()
            seg = torch.cumsum(seps[None].expand(B, S), -1, dtype=torch.int32).to(cuda)
        seed = torch.tensor([3], dtype=torch.int32, device=cuda)
        cfg = fa.FlashCfg(True, window, rate)
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*args, segment_ids=seg, attention_window=window,
                                 dropout_rate=rate, seed=seed)
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


def to_card(tensors, dtype, quant, device):
    """q and a float cache to ``dtype``; every tensor to the card."""
    q, k, v, mask, ks, vs = tensors
    q = q.to(dtype)
    if not quant:
        k, v = k.to(dtype), v.to(dtype)
    return [None if t is None else t.to(device) for t in (q, k, v, mask, ks, vs)]


def chunk_inputs(rng, B, Hkv, G, T, quant, S=96, D=48):
    """Packed caches, (B, Hq, T, D) query and a (B, T, S) staircase mask."""
    q, k, v, _, ks, vs = decode_inputs(rng, B, Hkv, G, quant, S=S, D=D)
    q = torch.from_numpy(rng.normal(size=(B, Hkv * G, T, D)).astype(np.float32))
    lengths = rng.integers(1, S - T + 1, B)
    pos = np.arange(S)[None, None, :]
    valid = pos < (lengths[:, None] + np.arange(T)[None, :] + 1)[:, :, None]
    valid[0, :, 2:9] = False  # a segment gap below slot 0's chunk
    mask = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, torch.from_numpy(mask), ks, vs


def chunk_bf16_bound(dev, Hkv):
    """Per-element bound on the bf16-query chunk kernel's error: it rounds
    each probability to bf16 (unit roundoff 2^-8) before P.V, where the plain
    version keeps it float32, so an output moves by at most 2^-8 times
    sum_j p_j |v_j| (the plain version run on |V|); the bound is twice that
    plus 1e-5 for the order of the float32 sums (``chip_smoke.py`` states
    the same bound)."""
    q, k, v, mask, ks, vs = dev
    mag = decode_attention_chunk_reference(q, k, v.abs(), mask, 1, ks, vs, kv_heads=Hkv)
    return 2.0**-7 * mag + 1e-5


@pytest.mark.cuda
def test_cuda_chunk_kernel_matches_plain_version(cuda):
    """The verify-chunk kernel against its plain version: T 5 over MHA in
    bf16 and int8 (tensor-core kernel, its stated per-element bound), and
    T 8 over GQA 4 in float32 (SIMT kernel, 32 rows per block, 1e-5)."""
    rng = np.random.default_rng(9)
    for (B, Hkv, G, T), quant, dtype in (((6, 4, 1, 5), False, torch.bfloat16),
                                         ((6, 4, 1, 5), True, torch.bfloat16),
                                         ((3, 2, 4, 8), False, torch.float32)):
        dev = to_card(chunk_inputs(rng, B, Hkv, G, T, quant), dtype, quant, cuda)
        before = decode_attention_chunk.launches
        got = decode_attention_chunk(*dev[:4], 1, *dev[4:], kv_heads=Hkv)
        want = decode_attention_chunk_reference(*dev[:4], 1, *dev[4:], kv_heads=Hkv)
        tol = chunk_bf16_bound(dev, Hkv) if dtype == torch.bfloat16 else 1e-5
        torch.cuda.synchronize()
        assert decode_attention_chunk.launches == before + 1
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("G,T", [(1, 1), (1, 5), (2, 4), (4, 8)], ids=["r1", "r5", "r8", "r32"])
def test_cuda_bf16_chunk_kernel_reads_only_live_tiles(cuda, G, T, quant):
    """The tensor-core chunk kernel at R = T x G = 1, 5, 8 and 32 rows over a
    cache of S 200 (not a multiple of 64): slot 0's live tiles stop at the
    first tile, slot 1's middle tile is wholly masked. The kernel runs on a
    cache whose dead tiles hold NaN (V and K, or an int8 cache's scales),
    which any read would carry into the output (0 x NaN), against the plain
    version on the clean cache."""
    rng = np.random.default_rng(12 + 10 * G + T + quant)
    B, Hkv, S = 4, 2, 200
    q, k, v, mask, ks, vs = chunk_inputs(rng, B, Hkv, G, T, quant, S=S, D=48)
    mask[0, :, 60:] = -1e30  # live tiles stop at the first ...
    mask[0, :, 40 + torch.arange(T)] = 0.0  # ... with each row's own slot attended
    mask[1, :, :] = 0.0
    mask[1, :, 64:128] = -1e30  # a wholly masked middle tile
    live = chunk_live_tiles(mask)
    assert live[0].tolist() == [True, False, False, False]
    assert live[1].tolist() == [True, False, True, True]
    dev = to_card((q, k, v, mask, ks, vs), torch.bfloat16, quant, cuda)
    want = decode_attention_chunk_reference(*dev[:4], 1, *dev[4:], kv_heads=Hkv)
    tol = chunk_bf16_bound(dev, Hkv)
    dead = (~live.repeat_interleave(64, 1)[:, :S]).to(cuda)
    if quant:
        scale_dead = dead[:, None, :].expand(B, Hkv, S)
        dev[4][:, scale_dead] = float("nan")
        dev[5][:, scale_dead] = float("nan")
    else:
        dev[1][:, dead] = float("nan")
        dev[2][:, dead] = float("nan")
    before = decode_attention_chunk.launches
    got = decode_attention_chunk(*dev[:4], 1, *dev[4:], kv_heads=Hkv)
    torch.cuda.synchronize()
    assert decode_attention_chunk.launches == before + 1
    assert bool(torch.isfinite(got).all()) and bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, T, S, D, window), <SEP> every (or "random" ids), dropout
    ((2, 2, 2, 100, 100, 16, None), 17, 0.1),
    ((2, 2, 2, 100, 100, 20, None), 17, 0.1),
    ((2, 2, 2, 192, 192, 48, None), 17, 0.1),
    ((2, 2, 2, 100, 100, 64, None), 17, 0.1),
    ((2, 2, 2, 100, 100, 128, None), 17, 0.1),
    ((2, 8, 2, 130, 333, 48, 50), 17, 0.1),
    ((2, 2, 2, 256, 256, 48, None), 4, 0.5),
    ((2, 2, 2, 192, 192, 48, None), "random", 0.1),
], ids=["d16", "d20", "d48", "d64", "d128", "gqa4_window50_offgrid", "seg4_dropout50",
        "random_ids"])
def test_cuda_bf16_dq_kernel_matches_plain_version(cuda, case):
    """The tensor-core dQ kernel alone against ``flash_bwd_dq_reference``
    (both given the plain forward's LSE): 2e-2 of the largest entry, since
    dS enters dS.K rounded to bf16 and dQ rounds to bf16; a wrongly skipped
    tile or keep bit (a segment every 4 tokens at dropout 0.5) moves entries
    by far more."""
    (B, Hq, Hkv, T, S, D, window), segs, rate = case
    rng = np.random.default_rng(13 + D + T)
    q, dout = (torch.from_numpy(rng.normal(size=(B, Hq, T, D)).astype(np.float32))
               .to(cuda, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Hkv, S, D)).astype(np.float32))
            .to(cuda, torch.bfloat16) for _ in range(2))
    if segs == "random":
        seg = torch.from_numpy(rng.integers(0, 4, (B, S)).astype(np.int32)).to(cuda)
    else:
        seps = (torch.arange(S) % segs == 0).int()
        seg = torch.cumsum(seps[None].expand(B, S), -1, dtype=torch.int32).to(cuda)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    cfg = fa.FlashCfg(True, window, rate)
    out, lse = fa.flash_forward_reference(q, k, v, seg, seed, cfg)
    delta = (dout.float() * out.float()).sum(-1)
    before = fa.flash_bwd_dq.launches
    got = fa.flash_bwd_dq(q, k, v, seg, seed, dout, lse, delta, cfg)
    want = fa.flash_bwd_dq_reference(q, k, v, seg, seed, dout, lse, delta, cfg)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == before + 1 and got.dtype == torch.bfloat16
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.cuda
def test_cuda_streamed_kernel_matches_plain_version(cuda):
    """The split-S kernel against its plain version: its default split and
    splits of 16 with a wholly masked first split, bf16, int8 and float32."""
    rng = np.random.default_rng(10)
    for (B, Hkv, G), quant, dtype, block_s, tol in (
            ((8, 2, 4), False, torch.bfloat16, None, 1e-3),
            ((8, 2, 4), True, torch.bfloat16, 16, 1e-3),
            ((3, 2, 2), False, torch.float32, 16, 1e-5)):
        q, k, v, mask, ks, vs = decode_inputs(rng, B, Hkv, G, quant)
        if block_s:
            mask[:, :block_s] = -1e30
            mask[:, -1] = 0.0
        dev = to_card((q, k, v, mask, ks, vs), dtype, quant, cuda)
        got = decode_attention_streamed(*dev[:4], 1, *dev[4:], kv_heads=Hkv, block_s=block_s)
        want = decode_attention_streamed_reference(*dev[:4], 1, *dev[4:], kv_heads=Hkv,
                                                   block_s=block_s)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("op", ["decode", "streamed"])
def test_cuda_single_token_kernels_read_only_live_tiles(cuda, op, quant):
    """The single-token kernels over a cache of S 200 (not a multiple of 64)
    whose dead tiles hold NaN (K and V, or an int8 cache's scales), which
    any read would carry into the output (0 x NaN), against the plain
    version on the clean cache (1e-3): slot 0 is live in its first tile
    only, slot 1's second tile is wholly masked (with splits of 64, a split
    with no live position), slot 2 is full, slot 3's segment starts at 130
    (tiles 0 and 1 dead)."""
    rng = np.random.default_rng(30 + quant + 2 * (op == "streamed"))
    B, Hkv, G, S = 4, 2, 2, 200
    q, k, v, _, ks, vs = decode_inputs(rng, B, Hkv, G, quant, S=S, D=48)
    mask = torch.zeros((B, S))
    mask[0, 40:] = -1e30
    mask[1, 64:128] = -1e30
    mask[3, :130] = -1e30
    live = decode_live_tiles(mask)
    assert live.tolist() == [[True, False, False, False], [True, False, True, True],
                             [True, True, True, True], [False, False, True, True]]
    dev = to_card((q, k, v, mask, ks, vs), torch.bfloat16, quant, cuda)
    if op == "decode":
        kernel, plain, kw = decode_attention, decode_attention_reference, {}
    else:
        kernel, plain = decode_attention_streamed, decode_attention_streamed_reference
        kw = {"block_s": 64}
    want = plain(*dev[:4], 1, *dev[4:], kv_heads=Hkv, **kw)
    dead = (~live.repeat_interleave(64, 1)[:, :S]).to(cuda)
    if quant:
        scale_dead = dead[:, None, :].expand(B, Hkv, S)
        dev[4][:, scale_dead] = float("nan")
        dev[5][:, scale_dead] = float("nan")
    else:
        dev[1][:, dead] = float("nan")
        dev[2][:, dead] = float("nan")
    before = kernel.launches
    got = kernel(*dev[:4], 1, *dev[4:], kv_heads=Hkv, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_cuda_chunk_and_streamed_refuse_shapes_outside_their_limits(cuda):
    """Past the kernels' limits the wrappers raise before any launch
    instead of taking the plain version."""
    rng = np.random.default_rng(11)
    G = 8
    T = KERNEL_MAX_CHUNK_ROWS // G + 1  # T x G rows exceed one block's bound
    dev = to_card(chunk_inputs(rng, 2, 1, G, T, False, S=64, D=16), torch.float32, False,
                  cuda)
    before = decode_attention_chunk.launches
    with pytest.raises(ValueError, match="chunk kernel takes"):
        decode_attention_chunk(*dev[:4], 0, kv_heads=1)
    assert decode_attention_chunk.launches == before
    dev = to_card(decode_inputs(rng, 2, 2, 1, False), torch.float16, False, cuda)
    before = decode_attention_streamed.launches
    with pytest.raises(ValueError, match="query"):
        decode_attention_streamed(*dev[:4], 0, kv_heads=2)
    assert decode_attention_streamed.launches == before


# --- the training stack on the card ----------------------------------------------


@pytest.mark.cuda
def test_cuda_prefetcher_waits_for_its_copies_and_keeps_their_memory(cuda):
    """``DevicePrefetcher`` stages from pinned memory on a side stream. The
    consumer must wait for the copy and ``record_stream`` the tensor: here a
    consumer reads each batch at once (a missing wait reads a half-copied
    128 MB batch), and reads it again from a kernel queued behind a long
    device spin after dropping its reference (a missing ``record_stream``
    lets the next copy reuse the memory first). Both reads must equal the
    host arrays."""
    import time

    from genomics_lm_torch.data.datasets import DevicePrefetcher

    n = 32 << 20
    host = [np.arange(n, dtype=np.int32) * (i + 3) + i for i in range(6)]
    first, late = [], []
    with DevicePrefetcher(iter(host), depth=2, device=cuda) as pf:
        for _ in host:
            x = next(pf)
            first.append(x[::4096].clone())  # at once, on the consumer stream
            torch.cuda._sleep(200_000_000)   # hold the consumer stream
            late.append(x[1::4096].clone())  # queued behind the spin
            del x
            time.sleep(0.02)  # the worker copies the next batches meanwhile
    torch.cuda.synchronize()
    for h, a, b in zip(host, first, late):
        assert np.array_equal(a.cpu().numpy(), h[::4096])
        assert np.array_equal(b.cpu().numpy(), h[1::4096])


def _trainer_fixture(tmp_path, block=32):
    from genomics_lm_torch.tokenizers.codon import write_itos

    rng = np.random.default_rng(0)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", 64), ("val", 16)):
        X = np.zeros((n, block), np.int32)
        X[:, 0] = rng.integers(4, 68, n)
        for t in range(1, block):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        X[:, ::11] = 3
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 0
        np.savez(tmp_path / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp_path / "itos.txt")
    return dict(train_npz=str(tmp_path / "train.npz"), val_npz=str(tmp_path / "val.npz"),
                block_size=block, n_layer=2, n_head=2, n_embd=32, dropout=0.0,
                label_smoothing=0.05, attention_impl="flash", batch_size=8,
                grad_accum_steps=2, lr=1e-3, min_lr=1e-4, warmup_steps=2, epochs=2,
                seed=1337, early_stop_patience=0, save_epochs=True)


@pytest.mark.cuda
def test_cuda_trainer_tracks_the_cpu_run(cuda, tmp_path):
    """A 2-layer float32 ``run_training`` on the card (flash kernels, float32
    SIMT) and on the CPU (their plain versions), from the same seed: the
    per-epoch losses agree within 1e-5 relative, the bound
    ``tests/test_torch_trainer.py`` holds the port to JAX with (TF32 off:
    only the order of float32 sums differs)."""
    from genomics_lm_torch.ops import flash_attention as fa_ops
    from genomics_lm_torch.training.checkpoints import load_checkpoint
    from genomics_lm_torch.training.loop import run_training

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _trainer_fixture(tmp_path)
    before = fa_ops.flash_bwd_dkv.launches
    for device in ("cuda", "cpu"):
        meta = run_training(dict(cfg, run_id=device), run_root=str(tmp_path / "runs"),
                            device=device)
        assert meta["status"] == "completed" and meta["device"].startswith(device)
    assert fa_ops.flash_bwd_dkv.launches - before == 2 * 2 * 4 * 2  # G x L x groups x epochs
    for epoch in (1, 2):
        card, cpu = (load_checkpoint(tmp_path / "runs" / d / "checkpoints" / f"epoch_{epoch}.npz")
                     for d in ("cuda", "cpu"))
        for key in ("train_loss", "val_loss", "val_next_loss"):
            assert abs(card[key] - cpu[key]) <= 1e-5 * abs(cpu[key]), (epoch, key)


@pytest.mark.cuda
def test_cuda_bf16_checkpoint_reloads_bit_exactly(cuda, tmp_path):
    """bf16 (and float32, int) tensors on the card, written directly and
    through ``AsyncCheckpointer``, reload with the same bits."""
    from genomics_lm_torch.training.checkpoints import (
        AsyncCheckpointer,
        load_checkpoint,
        save_checkpoint,
    )

    g = torch.Generator(device=cuda).manual_seed(0)
    b16 = torch.randn(257, 96, generator=g, device=cuda).bfloat16()
    f32 = torch.randn(33, generator=g, device=cuda)
    payload = {"model": {"w": b16, "b": f32, "n": torch.arange(5, device=cuda)},
               "t": (b16[:3],)}
    save_checkpoint(payload, tmp_path / "direct.npz")
    with AsyncCheckpointer() as ck:
        ck.save(payload, tmp_path / "async.npz")
    for name in ("direct.npz", "async.npz"):
        got = load_checkpoint(tmp_path / name)
        w = got["model"]["w"]
        assert w.dtype == torch.bfloat16 and torch.equal(
            w.view(torch.int16), b16.cpu().view(torch.int16))
        assert torch.equal(got["t"][0].view(torch.int16), b16[:3].cpu().view(torch.int16))
        assert np.array_equal(got["model"]["b"], f32.cpu().numpy())
        assert np.array_equal(got["model"]["n"], np.arange(5))


def _finetune_model(device, seed=0, **over):
    """A 2-layer model with LoRA r4 on the attention linears (``lora_b`` off
    zero) in the JAX layout, and its config; float32."""
    from genomics_lm_torch.models.codon_gpt import CodonGPT
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.training.lora import add_lora_adapters
    from genomics_lm_torch.utils.weights import params_to_jax

    kw = dict(vocab_size=68, block_size=128, n_layer=2, n_head=4, n_embd=256, dropout=0.0,
              label_smoothing=0.05, sep_id=3, attention_impl="flash", fused_qkv=True,
              termination_aux=True)
    kw.update(over)
    cfg = CodonGPTConfig(**kw)
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    tree = add_lora_adapters(params_to_jax(CodonGPT(cfg), cfg), rng, rank=4)
    for name in ("query", "key", "value", "proj"):
        b = tree["blocks"]["attn"][name]["lora_b"]
        tree["blocks"]["attn"][name]["lora_b"] = (0.02 * rng.standard_normal(b.shape)
                                                  ).astype(np.float32)
    return cfg, tree


def _group(rng, G=2, B=2, T=128):
    x = rng.integers(4, 68, (G, B, T))
    x[..., ::29] = 3
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _step_on(device, cfg, tree, run_cfg, batch, generator=None):
    from genomics_lm_torch.training.optim import build_optimizer
    from genomics_lm_torch.training.train_step import LossConfig, make_train_step
    from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax

    model = params_from_jax(tree, cfg, device).train()
    bundle = build_optimizer(run_cfg, model, total_steps=10)
    m = make_train_step(cfg, LossConfig())(
        model, bundle, {k: v.to(device) for k, v in batch.items()}, generator, 1.0)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(m["total_loss_sum"]), grads, params_to_jax(model, cfg)


@pytest.mark.cuda
def test_cuda_remat_with_dropout_equals_the_plain_step(cuda):
    """bf16 flash kernels with dropout 0.1: a group step with remat and one
    without, from one generator seed, give the same loss and gradients (the
    recomputed blocks draw the same seeds and masks and run the same
    kernels on the same inputs), and remat launches the forward twice."""
    cfg, tree = _finetune_model(cuda, dropout=0.1, compute_dtype="bfloat16")
    batch = _group(np.random.default_rng(1))
    out = {}
    for remat in (False, True):
        before = fa.flash_fwd.launches
        gen = torch.Generator(device=cuda).manual_seed(3)
        out[remat] = (*_step_on(cuda, cfg.replace(use_checkpoint=remat), tree,
                                {"lr": 1e-3, "warmup_steps": 0, "lora_rank": 4}, batch, gen),
                      fa.flash_fwd.launches - before)
    (l0, g0, _, n0), (l1, g1, _, n1) = out[False], out[True]
    assert n0 == 2 * 2 and n1 == 2 * n0  # G x layers; remat recomputes each forward
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    gmax = max(float(g.abs().max()) for g in g0.values())
    for n in g0:
        assert float((g0[n] - g1[n]).abs().max()) <= 1e-5 * gmax, n


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_cuda_fused_qkv_lora_step_tracks_the_cpu(cuda, optimizer):
    """The fused-QKV LoRA step at head width 64 (float32, TF32 off: the flash
    kernels' SIMT path on the card, their plain versions on the CPU), AdamW
    or Adafactor under lora_only with an active grad_clip: loss and
    gradients within 1e-5 relative (the order of float32 sums); parameters
    within two steps of lr 3e-5 (a gradient at rounding level may take
    opposite signs on the two sides, and either optimizer's first step is
    then +-lr); frozen ones equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tree = _finetune_model(cuda)
    assert cfg.head_dim == 64
    batch = _group(np.random.default_rng(2))
    run_cfg = {"lr": 3e-5, "warmup_steps": 0, "lora_rank": 4, "grad_clip": 0.01,
               "optimizer": optimizer}
    lc, gc, pc = _step_on("cpu", cfg, tree, run_cfg, batch)
    lg, gg, pg = _step_on(cuda, cfg, tree, run_cfg, batch)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert set(gg) == set(gc) and all("lora_" in n or "termination_head" in n for n in gc)
    gmax = max(float(g.abs().max()) for g in gc.values())
    for n in gc:
        assert float((gg[n] - gc[n]).abs().max()) <= 1e-5 * max(float(gc[n].abs().max()),
                                                               1e-3 * gmax), n

    def walk(a, b, path=""):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert float(np.abs(a[k] - b[k]).max()) <= 2 * 3e-5 * (1 + 1e-3), f"{path}/{k}"

    walk(pg, pc)


@pytest.mark.cuda
def test_cuda_decode_kernel_at_batch_one(cuda):
    """The decode kernel at ``CachedDecoder``'s shape: one sequence over a
    whole-block cache (10 layers, 8 kv heads of 48, S 512) with a prefix
    live, bf16 and int8 caches, against its plain version."""
    rng = np.random.default_rng(21)
    L, S, Hkv, D = 10, 512, 8, 48
    for quant in (False, True):
        q, k, v, _, ks, vs = decode_inputs(rng, 1, Hkv, 1, quant, L=L, S=S, D=D)
        mask = torch.full((1, S), -1e30)
        mask[0, :137] = 0.0
        q = q.to(torch.bfloat16)
        if not quant:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        dev = [None if t is None else t.to(cuda) for t in (q, k, v, mask, ks, vs)]
        for layer in (0, L - 1):
            got = decode_attention(*dev[:4], layer, *dev[4:], kv_heads=Hkv)
            want = decode_attention_reference(*dev[:4], layer, *dev[4:], kv_heads=Hkv)
            torch.cuda.synchronize()
            assert float((got.float() - want.float()).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_cuda_flash_forward_at_window_one(cuda):
    """The flash forward at inference with attention window 1 (only the
    diagonal is live) and 2, bf16 with ``<SEP>`` segments, batch 4 and batch
    1 over an off-grid length, against its plain version."""
    rng = np.random.default_rng(22)
    for B, T, window in ((4, 512, 1), (4, 512, 2), (1, 77, 1)):
        q, k, v = (torch.from_numpy(rng.normal(size=(B, 8, T, 48)).astype(np.float32))
                   .to(cuda, torch.bfloat16) for _ in range(3))
        seps = (torch.arange(T) % 97 == 0).int()
        seg = torch.cumsum(seps[None].expand(B, T), -1, dtype=torch.int32).to(cuda)
        seed = torch.zeros(1, dtype=torch.int32, device=cuda)
        cfg = fa.FlashCfg(True, window, 0.0)
        out, lse = fa.flash_fwd(q, k, v, seg, seed, cfg)
        ref, ref_lse = fa.flash_forward_reference(q, k, v, seg, seed, cfg)
        torch.cuda.synchronize()
        scale = max(1.0, float(ref.float().abs().max()))
        assert float((out.float() - ref.float()).abs().max()) <= 2e-2 * scale
        assert float((lse - ref_lse).abs().max()) <= 2e-2 * max(1.0, float(ref_lse.abs().max()))
        if window == 1:  # each query attends only itself: the output is its value
            assert float((out.float() - v.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.cuda
def test_cuda_int8_weight_greedy_serving_equals_the_cpu(cuda):
    """Greedy serving of a float32 model with int8 block linears gives the
    same tokens on the card (decode kernel, int8 and bf16 caches) as on the
    CPU (plain version)."""
    from genomics_lm_torch.models.codon_gpt import CodonGPT
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.ops.quant import quantize_params
    from genomics_lm_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CodonGPTConfig(vocab_size=68, block_size=128, n_layer=2, n_head=4, n_embd=64,
                         dropout=0.0, fused_qkv=True, attention_impl="flash")
    torch.manual_seed(23)
    cpu_model = quantize_params(CodonGPT(cfg).eval())
    gpu_model = quantize_params(CodonGPT(cfg).eval())
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(cuda)
    rng = np.random.default_rng(23)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, n)], 20) for n in (7, 19, 30)]

    def tokens(model, device, kv_quant):
        eng = ServingEngine(model, cfg, slots=2, max_seq_len=96, steps_per_sync=4,
                            kv_quant=kv_quant, device=device)
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    for kv_quant in (False, True):
        assert tokens(gpu_model, cuda, kv_quant) == tokens(cpu_model, "cpu", kv_quant)


def _moe_tree(seed=0, **over):
    """A 2-layer float32 MoE model (4 experts, top-2, capacity 0.5 so that
    tokens drop) in the JAX layout, and its config."""
    from genomics_lm_torch.models.codon_gpt import CodonGPT
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.utils.weights import params_to_jax

    kw = dict(vocab_size=68, block_size=128, n_layer=2, n_head=4, n_embd=256, dropout=0.0,
              label_smoothing=0.05, sep_id=3, attention_impl="flash", fused_qkv=True,
              moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
    kw.update(over)
    cfg = CodonGPTConfig(**kw)
    torch.manual_seed(seed)
    return cfg, params_to_jax(CodonGPT(cfg), cfg)


@pytest.mark.cuda
def test_cuda_moe_group_step_tracks_the_cpu(cuda):
    """A MoE group step in float32 (TF32 off; the flash kernels' SIMT path on
    the card, their plain versions on the CPU): loss and every gradient,
    the router's and each expert's, within 1e-5 relative (the order of
    float32 sums, and the combine's backward accumulates in another
    order on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tree = _moe_tree(1)
    batch = _group(np.random.default_rng(3))
    lc, gc, _ = _step_on("cpu", cfg, tree, {"lr": 1e-3, "warmup_steps": 0}, batch)
    lg, gg, _ = _step_on(cuda, cfg, tree, {"lr": 1e-3, "warmup_steps": 0}, batch)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert {n for n in gc if "router" in n or "mlp" in n} == {
        f"blocks.{i}.{p}" for i in range(2)
        for p in ("router.w", "mlp.fc.w", "mlp.fc.b", "mlp.proj.w", "mlp.proj.b")}
    gmax = max(float(g.abs().max()) for g in gc.values())
    for n in gc:
        assert float((gg[n] - gc[n]).abs().max()) <= 1e-5 * max(float(gc[n].abs().max()),
                                                               1e-3 * gmax), n


@pytest.mark.cuda
def test_cuda_moe_dropped_set_equals_the_cpu(cuda):
    """Capacity 0.5 drops about half the choices; the card and the CPU grant
    the same slots: the same experts and the same dropped (token, rank)
    pairs in every layer of a training forward."""
    from chip_smoke import recorded_routes
    from genomics_lm_torch.models.codon_gpt import forward
    from genomics_lm_torch.utils.weights import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tree = _moe_tree(2)
    x = _group(np.random.default_rng(4))["x"][0]
    got = []
    for dev in ("cpu", cuda):
        model = params_from_jax(tree, cfg, dev)
        with recorded_routes(keep=True) as routes, torch.no_grad():
            forward(model, cfg, x.to(dev), train=True)
        got.append(routes)
    assert len(got[0]) == len(got[1]) == 2
    for c, g in zip(*got):
        assert torch.equal(c["gate_idx"], g["gate_idx"])
        assert torch.equal(c["keep"], g["keep"]) and not c["keep"].all()


@pytest.mark.cuda
def test_cuda_moe_greedy_serving_equals_the_cpu(cuda):
    """Greedy serving of a float32 MoE model (dropless) gives the same
    tokens on the card (decode kernel; chunk kernel when speculative) as
    on the CPU, dense and int8 weights."""
    from genomics_lm_torch.ops.quant import quantize_params
    from genomics_lm_torch.serving.engine import ServingEngine
    from genomics_lm_torch.serving.speculative import fit_bigram_table
    from genomics_lm_torch.utils.weights import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tree = _moe_tree(5, n_embd=64)
    rng = np.random.default_rng(24)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, n)], 20) for n in (7, 19, 30)]
    table = fit_bigram_table(rng.integers(0, 68, 4000), 68)

    def tokens(device, int8, **kw):
        model = params_from_jax(tree, cfg, device)
        if int8:
            quantize_params(model)
        eng = ServingEngine(model, cfg, slots=2, max_seq_len=96, steps_per_sync=4,
                            device=device, **kw)
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    for int8 in (False, True):
        assert tokens(cuda, int8) == tokens("cpu", int8)
    assert (tokens(cuda, False, speculative_k=3, draft_table=table)
            == tokens("cpu", False, speculative_k=3, draft_table=table))


@pytest.mark.cuda
def test_cuda_flash_forward_at_the_motif_pass(cuda):
    """The flash forward at the motif pass's shape (heads of 48, windows of
    512 with their ``<SEP>`` segments; 16 rows of the pass's 199), bf16 and
    float32, against its plain version; then the window embeddings of a
    float32 flash model on the card against the CPU within 1e-5 of the
    largest."""
    import copy

    from genomics_lm_torch.evals.motifs import extract_window_embeddings
    from genomics_lm_torch.models.codon_gpt import CodonGPT
    from genomics_lm_torch.models.config import CodonGPTConfig
    from genomics_lm_torch.ops.masks import segment_ids_from_tokens

    rng = np.random.default_rng(31)
    B, T = 16, 512
    ids = torch.from_numpy(rng.integers(4, 68, (B, T)))
    ids[:, ::113] = 3
    seg = segment_ids_from_tokens(ids, 3).to(cuda, torch.int32)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    cfg = fa.FlashCfg(True, None, 0.0)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v = (torch.from_numpy(rng.normal(size=(B, 8, T, 48)).astype(np.float32))
                   .to(cuda, dtype) for _ in range(3))
        out, lse = fa.flash_fwd(q, k, v, seg, seed, cfg)
        ref, ref_lse = fa.flash_forward_reference(q, k, v, seg, seed, cfg)
        torch.cuda.synchronize()
        assert float((out.float() - ref.float()).abs().max()) <= tol * max(
            1.0, float(ref.float().abs().max()))
        assert float((lse - ref_lse).abs().max()) <= tol * max(1.0, float(ref_lse.abs().max()))

    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = CodonGPTConfig(vocab_size=68, block_size=128, n_layer=2, n_head=4, n_embd=64,
                          dropout=0.0, sep_id=3, fused_qkv=True, attention_impl="flash")
    torch.manual_seed(31)
    model = CodonGPT(mcfg).eval()
    x = rng.integers(4, 68, (3, 128)).astype(np.int32)
    x[:, 40] = 3
    x[1, -20:] = 0
    got, meta = extract_window_embeddings(copy.deepcopy(model).to(cuda), mcfg, x,
                                          exclude_ids=[0])
    want, want_meta = extract_window_embeddings(model, mcfg, x, exclude_ids=[0])
    assert meta == want_meta
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


@pytest.mark.cuda
def test_cuda_fit_mlp_tracks_the_cpu(cuda):
    """``fit_mlp`` at dropout 0 from one init: float32 on the card (TF32 off)
    against the CPU, parameters within 1e-5 of the largest and the same
    predictions."""
    from genomics_lm_torch.evals.probes import fit_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(32)
    X = rng.normal(size=(512, 64)).astype(np.float32)
    y = X[:, :5].argmax(axis=1)
    kw = dict(epochs=2, hidden=128, dropout=0.0, seed=3)
    card = fit_mlp(X, y, device=cuda, **kw)
    cpu = fit_mlp(X, y, device="cpu", **kw)
    for a, b in zip(card.params, cpu.params):
        for key in ("w", "b"):
            assert float(np.abs(a[key] - b[key]).max()) <= 1e-5 * float(np.abs(b[key]).max())
    np.testing.assert_array_equal(card.y_pred, cpu.y_pred)
