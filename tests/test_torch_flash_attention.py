"""Flash attention: the port's plain versions against the JAX Pallas kernels.

On the CPU the port's ``flash_attention`` runs its plain forward and
backward; the JAX function runs its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` does. The same numpy inputs go to both;
the forward must agree to 1e-5 and the gradients to 1e-4 of their largest
entry (both sides accumulate in float32, in different orders). Dropout has
its own stream (Philox-4x32-10, which the TPU's PRNG is not), so it is
checked on its own: the keep mask is a pure function of (seed, b, h, i, j)
with the right keep rate, and the plain backward equals autograd through
the dense einsum path given the same keep mask. The CUDA kernels need the
card: their test is in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.ops.flash_attention import flash_attention as jax_flash
from genomics_lm_tpu.ops.masks import segment_ids_from_tokens as jax_segments
from genomics_lm_torch.ops import flash_attention as fa
from genomics_lm_torch.ops.attention import attention, sdpa
from genomics_lm_torch.ops.masks import structure_mask

B, H, D = 2, 2, 16

# the six cases of tests/test_flash_attention.py, then suffix queries (T < S),
# an off-grid length and non-causal attention
CASES = [
    dict(),
    dict(seg=True),
    dict(window=9),
    dict(seg=True, window=21),
    dict(hkv=1),
    dict(seg=True, window=30, hkv=1),
    dict(T=16, seg=True, window=13),
    dict(T=76, S=76, seg=True, hkv=1),
    dict(causal=False, seg=True, window=40),
]


def make_case(case: dict, seed: int):
    rng = np.random.default_rng(seed)
    S = case.get("S", 64)
    T = case.get("T", S)
    hkv = case.get("hkv", H)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, hkv, S, D)).astype(np.float32)
    seg = None
    if case.get("seg"):
        tokens = rng.integers(4, 68, (B, S))
        tokens[:, ::17] = 3
        seg = np.asarray(jax_segments(jnp.asarray(tokens), 3)).astype(np.int32)
    return q, k, v, seg, case.get("window")


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_versions_match_jax_kernels(case):
    q, k, v, seg, window = make_case(case, seed=len(str(case)))
    jseg = None if seg is None else jnp.asarray(seg)

    causal = case.get("causal", True)

    def jax_fn(a, b, c):
        return jax_flash(a, b, c, segment_ids=jseg, attention_window=window, causal=causal,
                         interpret=True)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jax_fn(jq, jk, jv))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) ** 2), argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, attention_window=window, causal=causal,
                             segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
    (out ** 2).sum().backward()
    for w, g in zip(want_grads, (tq.grad, tk.grad, tv.grad)):
        w = np.asarray(w)
        scale = float(np.abs(w).max()) + 1e-9
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-4)


def _philox_int(ctr, key):
    """Philox-4x32-10 on Python ints: an independent reference."""
    m, w, mask = (0xD2511F53, 0xCD9E8D57), (0x9E3779B9, 0xBB67AE85), 0xFFFFFFFF
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + w[0]) & mask, (k[1] + w[1]) & mask]
        p0, p1 = m[0] * c[0], m[1] * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1], p0 & mask]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    """The Random123 known-answer vectors of philox4x32_10."""
    got = fa.philox4x32_10([torch.tensor(c) for c in ctr], [torch.tensor(x) for x in key])
    assert [int(g) for g in got] == list(want) == _philox_int(ctr, key)


def test_keep_mask_is_a_function_of_seed_b_h_i_j():
    seed, rate, Hq = torch.tensor([12345], dtype=torch.int32), 0.1, 3
    keep = fa.philox_keep(seed, 2, Hq, 40, 50, rate)
    # the same (b, h, i, j) in a larger call keeps the same bit
    big = fa.philox_keep(seed, 3, Hq, 47, 61, rate)
    assert torch.equal(big[:2, :, :40, :50], keep)
    threshold = fa.dropout_threshold(rate)
    rng = np.random.default_rng(0)
    for b, h, i, j in zip(rng.integers(0, 2, 20), rng.integers(0, Hq, 20),
                          rng.integers(0, 40, 20), rng.integers(0, 50, 20)):
        bits = _philox_int((int(i), int(j) // 4, 0, 0), (12345, int(b) * Hq + int(h)))
        assert bool(keep[b, h, i, j]) == (bits[int(j) % 4] >= threshold)
    assert not torch.equal(fa.philox_keep(seed + 1, 2, Hq, 40, 50, rate), keep)
    # keep rate 1 - p within 3 sigma of a binomial count
    n = keep.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(int(keep.sum()) - n * (1 - rate)) < 3 * sigma


def test_plain_backward_equals_autograd_of_dense_path_with_dropout():
    q, k, v, seg, _ = make_case(dict(seg=True, hkv=1, T=48, S=64), seed=3)
    rate, seed = 0.2, torch.tensor([77], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tseg = torch.from_numpy(seg)
    out = fa.flash_attention(tq, tk, tv, segment_ids=tseg, dropout_rate=rate, seed=seed)
    cot = torch.from_numpy(np.random.default_rng(4).normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (tq, tk, tv), cot)

    # dense reference: softmax of the masked scores, the same keep mask, einsum
    dq, dk, dv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    T, S = q.shape[2], k.shape[2]
    mask = structure_mask(T, S, segment_ids=tseg)  # (B, 1, T, S)
    kr, vr = dk.repeat_interleave(H, dim=1), dv.repeat_interleave(H, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", dq, kr) / D ** 0.5
    p = torch.softmax(s.masked_fill(~mask, fa.NEG_INF), dim=-1)
    keep = fa.philox_keep(seed, B, H, T, S, rate)
    ref = torch.einsum("bhts,bhsd->bhtd", torch.where(keep, p / (1 - rate), 0.0), vr)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5)
    want = torch.autograd.grad(ref, (dq, dk, dv), cot)
    for w, g in zip(want, got):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, atol=1e-5)


def test_einsum_path_drops_the_same_probabilities():
    """``impl="xla"`` draws its keep mask from the flash stream too."""
    q, k, v, seg, _ = make_case(dict(seg=True, hkv=1), seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(segment_ids=torch.from_numpy(seg), dropout_rate=0.3,
              seed=torch.tensor([9], dtype=torch.int32))
    flash = attention(*args, impl="flash", **kw)
    xla = attention(*args, impl="xla", **kw)
    np.testing.assert_allclose(flash.numpy(), xla.numpy(), atol=1e-5)
    assert not np.allclose(flash.numpy(), attention(*args, impl="xla")
                           .numpy(), atol=1e-3)
    no_seed = dict(kw, seed=None)  # no seed: no dropout, as JAX without a key
    np.testing.assert_allclose(attention(*args, impl="flash", **no_seed).numpy(),
                               sdpa(*args, mask=structure_mask(
                                   64, 64, segment_ids=kw["segment_ids"]))
                               .numpy(), atol=1e-5)


def test_wrapper_checks_contract():
    q, k, v, seg, _ = (None if a is None else torch.from_numpy(a)
                       for a in make_case(dict(seg=True), seed=6))
    with pytest.raises(ValueError, match="shorter"):
        fa.flash_attention(q, k[:, :, :32], v[:, :, :32])
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention(torch.cat([q, q[:, :1]], dim=1), k, v)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.double(), k, v)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention(q, k, v, segment_ids=seg.long())
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention(q, k, v, dropout_rate=0.1, seed=torch.tensor([1]))
    with pytest.raises(ValueError, match="dense mask"):
        attention(q, k, v, mask=torch.ones(64, 64, dtype=torch.bool), impl="flash")


def test_wrapper_raises_off_cpu_and_cuda():
    """No hidden fallback: a tensor on another device never reaches the plain path."""
    q, k, v = (torch.from_numpy(a).to("meta") for a in make_case({}, seed=7)[:3])
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    with pytest.raises(ValueError, match="not meta"):
        fa.flash_attention(q, k, v)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before

