"""PyTorch port of the continuous-batching engine: scheduling never changes
the numbers.

Greedy requests served by the port's ``ServingEngine`` on the CPU must emit
the JAX engine's tokens (JAX runs its Pallas decode kernel in interpret
mode) and the port's own offline ``generate_tokens`` tokens, through
admission, slot reuse, stop ids, cancellation and the int8 cache. Sampling
draws come from a torch generator, so sampled outputs are checked by
distribution. Follows ``tests/test_serving.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.serving import engine as jax_engine
from genomics_lm_torch.generation.decode import generate_tokens
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.parallel.mesh import make_mesh
from genomics_lm_torch.serving.engine import (
    ServingEngine,
    _ragged_decode,
    admit_many,
    filtered_sampling_logits,
    init_serving_state,
)
from genomics_lm_torch.utils.weights import params_from_jax


def make_pair(seed: int = 0, **over):
    kw = dict(vocab_size=68, block_size=96, n_layer=2, n_head=4, n_embd=64,
              dropout=0.0, sep_id=3, attention_impl="flash")
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return params, jcfg, model, tcfg


def engine(model, cfg, **kw):
    return ServingEngine(model, cfg, device="cpu", **kw)


def offline_greedy(model, cfg, prompt, n, kv_quant=False):
    toks = generate_tokens(model, cfg, [prompt], n, None, 0.0, kv_quant, device="cpu")
    return [int(t) for t in toks[0]]


def rand_prompts(rng, lengths):
    return [[1] + [int(t) for t in rng.integers(4, 68, n)] for n in lengths]


def test_greedy_matches_jax_engine():
    params, jcfg, model, tcfg = make_pair(n_kv_head=2, fused_qkv=True)
    rng = np.random.default_rng(0)
    reqs = list(zip(rand_prompts(rng, (5, 11, 17, 3)), (12, 7, 10, 9)))
    reqs[1][0][4] = 3  # a <SEP> inside one prompt

    def drain(eng):
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    want = drain(jax_engine.ServingEngine(params, jcfg, slots=2, steps_per_sync=4))
    assert drain(engine(model, tcfg, slots=2, steps_per_sync=4)) == want


def test_greedy_matches_offline_generation():
    _, _, model, tcfg = make_pair(use_rope=True, use_swiglu=True)
    rng = np.random.default_rng(1)
    prompts = rand_prompts(rng, (5, 11, 17, 3, 24))
    eng = engine(model, tcfg, slots=2, steps_per_sync=4)
    rids = [eng.submit(p, 12) for p in prompts]
    results = eng.run()
    for rid, p in zip(rids, prompts):
        assert results[rid].tokens == offline_greedy(model, tcfg, p, 12)
        assert results[rid].finish_reason == "length"


@pytest.mark.parametrize("kv_quant", [False, True])
def test_pipelined_drain_matches_sync_and_offline(kv_quant):
    """Every pipeline depth delivers the synchronous drain's tokens, through
    slot reuse under queue pressure; both equal offline generation."""
    _, _, model, tcfg = make_pair()
    rng = np.random.default_rng(6)
    reqs = list(zip(rand_prompts(rng, (6, 12, 4, 9, 15)), (8, 5, 14, 7, 4)))

    def drain(pipelined, depth=1):
        eng = engine(model, tcfg, slots=2, steps_per_sync=4, kv_quant=kv_quant,
                     pipeline_depth=depth)
        rids = [eng.submit(p, b) for p, b in reqs]
        res = eng.run(pipelined=pipelined)
        return [res[r].tokens for r in rids]

    sync = drain(False)
    assert drain(True) == sync
    assert drain(True, depth=2) == sync
    assert sync == [offline_greedy(model, tcfg, p, b, kv_quant) for p, b in reqs]


def test_stream_yields_incremental_deltas():
    _, _, model, tcfg = make_pair()
    rng = np.random.default_rng(3)
    eng = engine(model, tcfg, slots=2, steps_per_sync=4)
    rids = [eng.submit(p, 13) for p in rand_prompts(rng, (6, 6, 6))]
    deltas = {r: [] for r in rids}
    finishes = {r: [] for r in rids}
    for rid, toks, reason in eng.stream():
        deltas[rid].extend(toks)
        finishes[rid].append(reason)
    for rid in rids:
        assert deltas[rid] == eng.results[rid].tokens
        assert len(finishes[rid]) >= 2
        assert all(r == "" for r in finishes[rid][:-1])
        assert finishes[rid][-1] == "length"


def test_stop_ids_cancel_and_slot_reuse():
    _, _, model, tcfg = make_pair()
    prompt = [1, 10, 11, 12]
    full = offline_greedy(model, tcfg, prompt, 16)
    stop = full[4]
    first = full.index(stop)
    eng = engine(model, tcfg, slots=1, steps_per_sync=3)
    rid_a = eng.submit(prompt, 16, stop_ids=(stop,))
    rid_b = eng.submit(prompt, 6)  # must reuse the freed slot
    results = eng.run()
    assert results[rid_a].finish_reason == "stop"
    assert results[rid_a].tokens == full[: first + 1]
    assert results[rid_b].tokens == full[:6]

    rng = np.random.default_rng(9)
    eng = engine(model, tcfg, slots=2, steps_per_sync=4)
    r1, r2, r3 = (eng.submit(p, 20) for p in rand_prompts(rng, (6, 6, 6)))
    eng.step()
    assert eng.cancel(r3) and eng.cancel(r1)
    assert not eng.cancel(r1) and not eng.cancel(999)
    res = eng.run()
    assert res[r1].finish_reason == "cancelled"
    assert res[r3].finish_reason == "cancelled" and res[r3].tokens == []
    assert res[r2].finish_reason == "length" and len(res[r2].tokens) == 20
    st = eng.stats()
    assert st["active"] == 0 and st["pending"] == 0 and st["completed"] == 3


def test_slot_reuse_does_not_leak_state():
    _, _, model, tcfg = make_pair()
    rng = np.random.default_rng(2)
    long_p, short_p = rand_prompts(rng, (30, 4))
    long_p[10] = 3  # stale segment ids above the short request's length
    eng = engine(model, tcfg, slots=1, steps_per_sync=8)
    eng.submit(long_p, 20)
    rid = eng.submit(short_p, 8)
    assert eng.run()[rid].tokens == offline_greedy(model, tcfg, short_p, 8)


def test_admit_many_routing():
    """Valid lanes install into their slots; invalid lanes are inert; other
    slots, and positions past the admitted width, keep their state."""
    _, _, model, tcfg = make_pair()
    st = init_serving_state(tcfg, slots=4, cache_size=32, kv_quant=True, device="cpu")
    st["lengths"][1] = 7
    st["active"][1] = True
    st["k"][:, 1] = 3
    st["k"][:, 3, 20:] = 5
    before_slot1 = st["k"][:, 1].clone()
    rng = np.random.default_rng(0)
    prompts = np.zeros((4, 16), np.int64)
    prompts[0, :5] = rng.integers(4, 68, 5)
    prompts[2, :9] = rng.integers(4, 68, 9)
    out = admit_many(model, tcfg, st, np.array([3, 0, 0, 0]), prompts,
                     np.array([5, 1, 9, 1]), np.array([True, False, True, False]))
    assert out is st
    assert st["lengths"].tolist() == [9, 7, 0, 5]
    assert st["active"].tolist() == [True, True, False, True]
    torch.testing.assert_close(st["k"][:, 1], before_slot1)
    assert bool((st["k"][:, 3, 20:] == 5).all())
    assert bool((st["k"][:, 3, :5] != 0).any()) and bool((st["k_scale"][:, 3, :, :5] > 0).all())


def test_ragged_decode_matches_jax_through_sep_tokens():
    """Feed the same tokens, <SEP>s included, to both ragged decode steps
    after the same admission: logits and every piece of slot state agree.
    Slot 2 stays inactive and must keep its length."""
    params, jcfg, model, tcfg = make_pair(use_rope=True, n_kv_head=2)
    B, S = 3, 32
    rng = np.random.default_rng(12)
    prompts = np.zeros((B, 16), np.int32)
    lens = np.array([5, 9, 12], np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(4, 68, n)
    prompts[1, 4] = 3
    slot_idx, valid = np.arange(B, dtype=np.int32), np.array([True, True, False])
    jst = jax_engine.admit_many(
        params, jcfg, jax_engine.init_serving_state(jcfg, B, S),
        *(jnp.asarray(a) for a in (slot_idx, prompts, lens, valid)))
    tst = admit_many(model, tcfg, init_serving_state(tcfg, B, S, device="cpu"),
                     slot_idx, prompts, lens, valid)
    for tokens in ([10, 3, 0], [3, 20, 0], [30, 40, 0]):
        jl, jst = jax_engine._ragged_decode(params, jcfg, jst, jnp.asarray(tokens, jnp.int32))
        tl, tst = _ragged_decode(model, tcfg, tst, torch.tensor(tokens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for key in ("seg", "lengths", "seg_count", "active"):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]))
    np.testing.assert_allclose(tst["k"].numpy(), np.asarray(jst["k"]), atol=1e-5)
    assert tst["lengths"].tolist() == [8, 12, 0]


def test_filtered_sampling_logits_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(5, 68)).astype(np.float32) * 3
    sampling = {
        "temps": np.array([0.0, 1.0, 0.7, 1.3, 2.0], np.float32),
        "top_k": np.array([0, 5, 0, 12, 1], np.int32),
        "top_p": np.array([0.0, 0.0, 0.8, 0.5, 1.0], np.float32),
    }
    allowed = np.ones(68, bool)
    allowed[:4] = False
    want_g, want_s = jax_engine.filtered_sampling_logits(
        jnp.asarray(logits), {k: jnp.asarray(v) for k, v in sampling.items()},
        jnp.asarray(allowed))
    got_g, got_s = filtered_sampling_logits(
        torch.from_numpy(logits), {k: torch.from_numpy(v) for k, v in sampling.items()},
        torch.from_numpy(allowed))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)


def test_sampled_tokens_follow_the_distribution():
    """The engine's sampler draws from softmax(logits / T): the total-variation
    distance of 50k draws on one fixed logits row stays under 0.03 (about
    twice its expected sampling noise over 68 categories)."""
    from genomics_lm_torch.generation.decode import sample_categorical

    logits = torch.from_numpy(
        np.random.default_rng(11).normal(size=(1, 68)).astype(np.float32) * 1.5)
    n, temp = 50_000, 1.3
    sampling = {"temps": torch.full((n,), temp), "top_k": torch.zeros(n, dtype=torch.int32),
                "top_p": torch.zeros(n)}
    _, scaled = filtered_sampling_logits(logits.expand(n, -1), sampling, None)
    draws = sample_categorical(scaled, torch.Generator().manual_seed(3)).numpy()
    freq = np.bincount(draws, minlength=68) / n
    want = torch.softmax(logits[0] / temp, -1).numpy()
    assert 0.5 * np.abs(freq - want).sum() < 0.03


def test_per_slot_temperature_and_allowed_ids():
    _, _, model, tcfg = make_pair()
    prompt = [1, 30, 31, 32, 33]
    expect = offline_greedy(model, tcfg, prompt, 8)
    eng = engine(model, tcfg, slots=2, steps_per_sync=4, seed=7,
                 allowed_ids=list(range(4, 68)))
    rid_g = eng.submit(prompt, 8, temperature=0.0)
    rid_s = eng.submit(prompt, 8, temperature=2.0, top_k=10)
    results = eng.run()
    if all(t >= 4 for t in expect):
        assert results[rid_g].tokens == expect
    assert len(results[rid_s].tokens) == 8
    assert all(4 <= t < 68 for t in results[rid_s].tokens + results[rid_g].tokens)


def test_validation_and_unported_options():
    _, _, model, tcfg = make_pair()
    eng = engine(model, tcfg, slots=1, max_seq_len=32)
    with pytest.raises(ValueError):
        eng.submit(list(range(4, 30)), 10)
    with pytest.raises(ValueError):
        eng.submit([1, 99], 3)
    with pytest.raises(ValueError):
        engine(model, tcfg, max_seq_len=128)
    with pytest.raises(ValueError, match="requires a draft_table"):
        engine(model, tcfg, speculative_k=2)  # speculative serving needs a draft
    # a model axis must divide the heads (JAX's engine raises alike); one of
    # size 1 splits nothing and is dropped (tensor-parallel drains:
    # tests/test_torch_tp_serving.py)
    with pytest.raises(ValueError, match="must divide over model=3"):
        engine(model, tcfg, mesh=make_mesh(devices=[0, 1, 2], axes={"model": 3}))
    assert not engine(model, tcfg, mesh=make_mesh(devices=[0], axes={"model": 1})
                      ).stats()["tensor_parallel"]
    with pytest.raises(ValueError, match="model parameters are on cpu"):
        ServingEngine(model, tcfg, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(model, tcfg)
