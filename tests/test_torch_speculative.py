"""PyTorch port of speculative decoding against the JAX package.

The same JAX weights (carried over by ``utils/weights.py::params_from_jax``)
and the same numpy inputs go to both packages on the CPU; models are small
(2 layers, d 64, block 96, float32). JAX runs its Pallas verify-chunk
kernel in interpret mode; the port runs the kernel's plain version.
Tolerances: 1e-4 on logits and 1e-5 on float caches (float32 sums in other
orders), exact on segment ids, token ids and acceptance counts, 1e-6 on
acceptance distributions. Sampled draws come from a torch generator, so
sampled outputs are checked by distribution. Follows
``tests/test_speculative.py``.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.generation import decode as jax_decode
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.serving import engine as jax_engine
from genomics_lm_tpu.serving import speculative as jax_spec
from genomics_lm_torch.generation.decode import (
    decode_step,
    generate_masked_tokens,
    generate_tokens,
    prefill,
    sample_categorical,
)
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.serving.engine import (
    ServingEngine,
    _ragged_decode,
    admit_many,
    init_serving_state,
)
from genomics_lm_torch.serving.speculative import (
    _ragged_verify,
    fit_bigram_table,
    generate_tokens_speculative,
    restrict_table,
    speculative_acceptance,
    speculative_generate,
)
from genomics_lm_torch.utils.weights import params_from_jax

LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5


def make_pair(seed: int = 0, **over):
    kw = dict(vocab_size=68, block_size=96, n_layer=2, n_head=4, n_embd=64,
              dropout=0.0, sep_id=3, attention_impl="flash")
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return params, jcfg, model, tcfg


def rand_prompts(rng, lengths):
    return [[1] + [int(t) for t in rng.integers(4, 68, n)] for n in lengths]


def offline_greedy(model, cfg, prompt, n):
    return [int(t) for t in generate_tokens(model, cfg, [prompt], n, None, 0.0,
                                            device="cpu")[0]]


def admitted_states(params, jcfg, model, tcfg, prompt_lens, kv_quant, cache=48):
    """The same ragged prompts admitted into a JAX and a port serving state."""
    rng = np.random.default_rng(7)
    B = len(prompt_lens)
    prompts = np.zeros((B, 32), np.int32)
    for i, n in enumerate(prompt_lens):
        prompts[i, 0] = 1
        prompts[i, 1:n] = rng.integers(4, 68, n - 1)
    lens = np.asarray(prompt_lens, np.int32)
    slots, valid = np.arange(B, dtype=np.int32), np.ones((B,), bool)
    jst = jax_engine.admit_many(
        params, jcfg, jax_engine.init_serving_state(jcfg, B, cache, kv_quant),
        *(jnp.asarray(a) for a in (slots, prompts, lens, valid)))
    tst = admit_many(model, tcfg, init_serving_state(tcfg, B, cache, kv_quant, device="cpu"),
                     slots, prompts, lens, valid)
    return jst, tst


def verify_tokens(B, T, seed=1):
    tokens = np.random.default_rng(seed).integers(4, 68, (B, T)).astype(np.int32)
    tokens[0, 2] = 3  # a <SEP> mid-chunk resets the segment
    tokens[B - 1, 0] = 3
    return tokens


def assert_int8_cache_close(got, want):
    """int8 codes from two float paths may sit on either side of a rounding
    edge: they agree to one step, and almost all agree exactly."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("over,kv_quant", [
    (dict(use_rope=True, use_swiglu=True, n_kv_head=2), False),
    (dict(use_rope=False), False),
    (dict(use_rope=True, n_kv_head=2), True),
], ids=["rope_swiglu_gqa", "learned_positions", "int8"])
def test_ragged_verify_matches_jax(over, kv_quant):
    """Logits, written caches, segment ids and chunk segments of one verify
    chunk, after the same admission, agree with JAX's."""
    params, jcfg, model, tcfg = make_pair(**over)
    jst, tst = admitted_states(params, jcfg, model, tcfg, [5, 9, 3], kv_quant)
    tst["active"][2] = False  # a frozen slot keeps its segment ids
    jst = dict(jst, active=jnp.asarray([True, True, False]))
    tokens = verify_tokens(3, 5)
    jl, jupd, jseg = jax_spec._ragged_verify(params, jcfg, jst, jnp.asarray(tokens))
    tl, tupd, tseg = _ragged_verify(model, tcfg, tst, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL)
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(tupd["seg"].numpy(), np.asarray(jupd["seg"]))
    for key in ("k", "v"):
        if kv_quant:
            assert_int8_cache_close(tupd[key].numpy(), np.asarray(jupd[key]))
        else:
            np.testing.assert_allclose(tupd[key].numpy(), np.asarray(jupd[key]),
                                       atol=CACHE_ATOL)
    if kv_quant:
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tupd[key].numpy(), np.asarray(jupd[key]),
                                       atol=CACHE_ATOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_ragged_verify_matches_stepwise_decode(kv_quant):
    """One chunk forward equals T single-token ragged decode steps: logits
    (int8: the cache rows are requantized per path, so logits agree to
    2e-2 as in ``tests/test_speculative.py``), caches and segments."""
    _, _, model, tcfg = make_pair(use_rope=True, use_swiglu=True, n_kv_head=2)
    st = init_serving_state(tcfg, 3, 48, kv_quant, device="cpu")
    rng = np.random.default_rng(3)
    prompts = np.zeros((3, 16), np.int64)
    lens = np.array([5, 9, 3])
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(4, 68, n)
    admit_many(model, tcfg, st, np.arange(3), prompts, lens, np.ones(3, bool))
    step_st = copy.deepcopy(st)
    tokens = torch.from_numpy(verify_tokens(3, 5, seed=4)).long()
    chunk_logits, upd, chunk_seg = _ragged_verify(model, tcfg, st, tokens)
    rows, segs = [], []
    for t in range(tokens.shape[1]):
        logits, step_st = _ragged_decode(model, tcfg, step_st, tokens[:, t])
        rows.append(logits)
        segs.append(step_st["seg_count"])
    tol = 2e-2 if kv_quant else LOGITS_ATOL
    np.testing.assert_allclose(chunk_logits.numpy(), torch.stack(rows, 1).numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_array_equal(chunk_seg.numpy(), torch.stack(segs, 1).numpy())
    np.testing.assert_array_equal(upd["seg"].numpy(), step_st["seg"].numpy())
    if not kv_quant:
        for key in ("k", "v"):
            np.testing.assert_allclose(upd[key].numpy(), step_st[key].numpy(),
                                       atol=CACHE_ATOL)


def test_acceptance_matches_jax():
    rng = np.random.default_rng(0)
    B, K, V = 64, 3, 7
    P = rng.dirichlet(np.ones(V), (B, K + 1)).astype(np.float32)
    Q = rng.dirichlet(np.ones(V), (B, K)).astype(np.float32)
    drafts = rng.integers(0, V, (B, K)).astype(np.int32)
    U = rng.random((B, K)).astype(np.float32)
    P[0, :, 2] = 0.0  # a draft the target never emits
    drafts[0, 0] = 2
    jm, jnext = jax_spec.speculative_acceptance(
        *(jnp.asarray(a) for a in (P, Q, drafts, U)))
    tm, tnext = speculative_acceptance(
        *(torch.from_numpy(a) for a in (P, Q, drafts, U)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tnext.numpy(), np.asarray(jnext), atol=1e-6)
    assert set(tm.tolist()) == set(range(K + 1))  # every prefix length occurs


def test_acceptance_greedy_one_hot_target():
    """A one-hot P accepts the argmax draft and rejects any other, with a
    one-hot residual: speculative greedy is greedy."""
    V, K = 5, 2
    P = np.zeros((2, K + 1, V), np.float32)
    P[:, :, 2] = 1.0
    Q = np.full((2, K, V), 1.0 / V, np.float32)
    drafts = np.array([[2, 2], [2, 4]])
    U = np.full((2, K), 0.999, np.float32)
    m, nxt = speculative_acceptance(*(torch.from_numpy(a) for a in (P, Q, drafts, U)))
    assert m.tolist() == [2, 1]
    np.testing.assert_array_equal(nxt.numpy(), P[:, 0])


def test_one_hot_log_probabilities_sample_their_argmax(monkeypatch):
    """log of a one-hot row is -inf off the argmax; a uniform draw of
    exactly 0 must still return the argmax (uniforms floored at tiny)."""
    probs = torch.zeros((4, 68))
    probs[torch.arange(4), torch.tensor([5, 0, 67, 30])] = 1.0
    monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.zeros(shape))
    assert sample_categorical(torch.log(probs)).tolist() == [5, 0, 67, 30]


def test_draft_tables_match_jax():
    rng = np.random.default_rng(1)
    windows = rng.integers(0, 68, (6, 40))
    windows[:, :3] = 0
    for stream, kw in (([np.array([1, 2, 3, 2, 1])], dict(alpha=0.1)),
                       (windows, dict(exclude_ids=(0,))),
                       (rng.integers(0, 68, 500), {})):
        want = jax_spec.fit_bigram_table(stream, 68, **kw)
        got = fit_bigram_table(stream, 68, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    allowed = np.zeros(68, bool)
    allowed[4:] = True
    got = restrict_table(fit_bigram_table(windows, 68), allowed)
    np.testing.assert_array_equal(got, jax_spec.restrict_table(
        jax_spec.fit_bigram_table(windows, 68), allowed))
    assert (got[:, ~allowed] == 0).all()


@pytest.mark.parametrize("n_tokens,n_draft,plen,batch", [
    (16, 3, 8, 4),  # the main case
    (1, 3, 4, 2),   # K > n_tokens: overshoot parks in the scratch column
    (2, 4, 1, 2),   # minimal prompt
    (5, 1, 3, 2),   # minimal draft
])
def test_greedy_speculative_equals_generate_tokens(n_tokens, n_draft, plen, batch):
    """Greedy speculative generation gives the port's and JAX's
    ``generate_tokens`` tokens, token for token."""
    params, jcfg, model, tcfg = make_pair(use_rope=True)
    rng = np.random.default_rng(20 + n_tokens)
    prompts = np.concatenate(
        [np.ones((batch, 1), np.int32),
         rng.integers(4, 68, (batch, plen - 1)).astype(np.int32)], axis=1)
    want = np.asarray(jax_decode.generate_tokens(
        params, jcfg, jnp.asarray(prompts), n_tokens, jax.random.PRNGKey(5), 0.0))
    plain = generate_tokens(model, tcfg, prompts, n_tokens, None, 0.0, device="cpu")
    table = fit_bigram_table(rng.integers(0, 68, 3000), 68)
    spec, stats = speculative_generate(model, tcfg, prompts, n_tokens, None, table,
                                       n_draft=n_draft, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(spec, want)
    assert stats["tokens_per_round"] >= 1.0 and 0.0 <= stats["accept_rate"] <= 1.0


def test_masked_greedy_equals_generate_masked_tokens():
    """CDS-restricted speculative greedy == ``generate_masked_tokens`` greedy,
    port and JAX."""
    params, jcfg, model, tcfg = make_pair()
    rng = np.random.default_rng(8)
    allowed = np.zeros((68,), bool)
    allowed[4:] = True
    prompts = np.concatenate(
        [np.ones((3, 1), np.int32), rng.integers(4, 68, (3, 5)).astype(np.int32)], axis=1)
    want = np.asarray(jax_decode.generate_masked_tokens(
        params, jcfg, jnp.asarray(prompts), 12, jax.random.PRNGKey(5), 0.0,
        jnp.asarray(allowed)))
    masked = generate_masked_tokens(model, tcfg, prompts, 12, None, 0.0, allowed,
                                    device="cpu")
    table = restrict_table(fit_bigram_table(rng.integers(0, 68, 4000), 68), allowed)
    spec, _, _ = generate_tokens_speculative(model, tcfg, prompts, 12, None, table, 3, 0.0,
                                             False, allowed, device="cpu")
    np.testing.assert_array_equal(masked.numpy(), want)
    np.testing.assert_array_equal(spec.numpy(), want)
    assert bool(allowed[spec.numpy()].all())


def test_sampled_speculative_preserves_the_distribution():
    """The empirical joint of 2 speculatively sampled tokens (8000 rows, a
    draft unlike the target) is within total variation 0.08 of the exact
    target joint at temperature 0.9 (sampling noise ≈ 0.035)."""
    _, _, model, tcfg = make_pair(vocab_size=8, block_size=16, n_layer=1, n_head=2,
                                  n_embd=16)
    temp = 0.9
    prompt = np.array([[1, 4]])
    logits0, cache, _ = prefill(model, tcfg, prompt, device="cpu")
    p1 = torch.softmax(logits0[0] / temp, -1).numpy()
    joint = np.zeros((8, 8))
    for t1 in range(8):
        logits1, _, _ = decode_step(model, tcfg, copy.deepcopy(cache), [t1])
        joint[t1] = p1[t1] * torch.softmax(logits1[0] / temp, -1).numpy()
    table = fit_bigram_table(np.random.default_rng(0).integers(0, 8, 2000), 8)
    B = 8000
    spec, stats = speculative_generate(
        model, tcfg, np.tile(prompt, (B, 1)), 2, torch.Generator().manual_seed(11),
        table, n_draft=2, temperature=temp, device="cpu")
    emp = np.zeros((8, 8))
    np.add.at(emp, (spec[:, 0], spec[:, 1]), 1.0 / B)
    tv = 0.5 * np.abs(emp - joint).sum()
    assert tv < 0.08, f"TV distance {tv:.4f}"
    assert 0.0 <= stats["accept_rate"] <= 1.0


def spec_engine(model, cfg, table, **kw):
    return ServingEngine(model, cfg, speculative_k=kw.pop("speculative_k", 3),
                         draft_table=table, device="cpu", **kw)


def test_engine_greedy_matches_offline_under_coscheduling():
    _, _, model, tcfg = make_pair()
    rng = np.random.default_rng(4)
    prompts = rand_prompts(rng, (5, 11, 17, 3, 24))
    table = fit_bigram_table(rng.integers(0, 68, 4000), 68)
    eng = spec_engine(model, tcfg, table, slots=2, steps_per_sync=3)
    rids = [eng.submit(p, 12) for p in prompts]
    results = eng.run()
    for rid, p in zip(rids, prompts):
        assert results[rid].tokens == offline_greedy(model, tcfg, p, 12)
        assert results[rid].finish_reason == "length"
    stats = eng.stats()
    assert stats["speculative_k"] == 3 and stats["decode_steps"] == 0
    assert stats["verify_rounds"] > 0 and stats["verify_rounds"] % 3 == 0
    assert 0.0 <= stats["speculative_accept_rate"] <= 1.0
    assert 1.0 <= stats["speculative_tokens_per_round"] <= 4.0


def test_engine_greedy_matches_jax_engine():
    """The port's speculative engine emits the JAX speculative engine's
    greedy tokens (JAX verifies with its Pallas chunk kernel, interpreted)."""
    params, jcfg, model, tcfg = make_pair(n_kv_head=2, fused_qkv=True)
    rng = np.random.default_rng(14)
    reqs = list(zip(rand_prompts(rng, (5, 11, 17)), (12, 7, 10)))
    table = fit_bigram_table(rng.integers(0, 68, 4000), 68)

    def drain(eng):
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    want = drain(jax_engine.ServingEngine(params, jcfg, slots=2, steps_per_sync=3,
                                          speculative_k=3, draft_table=table))
    assert drain(spec_engine(model, tcfg, table, slots=2, steps_per_sync=3)) == want


def test_engine_stop_ids_and_budget():
    _, _, model, tcfg = make_pair()
    rng = np.random.default_rng(5)
    table = fit_bigram_table(rng.integers(0, 68, 4000), 68)
    prompt = rand_prompts(rng, (6,))[0]
    probe = offline_greedy(model, tcfg, prompt, 20)
    stop = probe[7]
    eng = spec_engine(model, tcfg, table, slots=2, steps_per_sync=4, speculative_k=2)
    rid = eng.submit(prompt, 20, stop_ids=(stop,))
    rid_budget = eng.submit(prompt, 5)
    res = eng.run()
    # speculative overshoot past the first stop and past a budget is dropped
    assert res[rid].finish_reason == "stop"
    assert res[rid].tokens == probe[: probe.index(stop) + 1]
    assert res[rid_budget].finish_reason == "length" and res[rid_budget].tokens == probe[:5]


def test_engine_allowed_ids_restrict_sampled_tokens():
    _, _, model, tcfg = make_pair()
    rng = np.random.default_rng(6)
    allowed = list(range(4, 68))
    table = fit_bigram_table(rng.integers(0, 68, 4000), 68)
    eng = spec_engine(model, tcfg, table, slots=2, steps_per_sync=3, allowed_ids=allowed)
    assert bool((eng._table[:, :4] == 0).all())  # the draft table is restricted too
    rids = [eng.submit(p, 15, temperature=1.0, top_k=12)
            for p in rand_prompts(rng, (5, 9))]
    res = eng.run()
    for rid in rids:
        assert len(res[rid].tokens) == 15
        assert all(4 <= t < 68 for t in res[rid].tokens)


def test_engine_greedy_unaffected_by_sampled_neighbours():
    """A greedy request co-scheduled with sampled, filtered slots emits its
    solo greedy stream: sampling transforms and acceptance stay per row."""
    _, _, model, tcfg = make_pair(use_rope=True)
    rng = np.random.default_rng(13)
    table = fit_bigram_table(rng.integers(0, 68, 4000), 68)
    probe = rand_prompts(rng, (7,))[0]
    eng = spec_engine(model, tcfg, table, slots=3, steps_per_sync=3)
    rid = eng.submit(probe, 10)
    for n in (5, 12):
        eng.submit(rand_prompts(rng, (n,))[0], 9, temperature=1.1, top_k=8)
    assert eng.run()[rid].tokens == offline_greedy(model, tcfg, probe, 10)


def test_engine_filtered_slots_accept_a_fitted_draft():
    """Under top_k=1 on every slot (the filter chain pinned on by
    ``warm_spec_filters``) a draft fitted to the model's own greedy streams
    is still accepted, and the greedy rows stay exact."""
    _, _, model, tcfg = make_pair()
    rng = np.random.default_rng(21)
    prompts = rand_prompts(rng, (7, 12, 9))
    streams = [np.asarray(p + offline_greedy(model, tcfg, p, 16)) for p in prompts]
    table = fit_bigram_table(streams, 68, alpha=0.01)
    eng = spec_engine(model, tcfg, table, slots=2, steps_per_sync=3,
                      warm_spec_filters=True)
    rids = [eng.submit(p, 10, temperature=0.0, top_k=1) for p in prompts]
    res = eng.run()
    for rid, p in zip(rids, prompts):
        assert res[rid].tokens == offline_greedy(model, tcfg, p, 10)
    assert eng.stats()["speculative_accept_rate"] > 0.0


def test_engine_int8_cache_and_headroom():
    """The int8 speculative engine serves every budget in the vocabulary,
    and the cache carries K+1 positions of headroom rounded to 128."""
    _, _, model, tcfg = make_pair()
    rng = np.random.default_rng(22)
    table = fit_bigram_table(rng.integers(0, 68, 4000), 68)
    eng = spec_engine(model, tcfg, table, slots=2, steps_per_sync=4, kv_quant=True,
                      max_seq_len=64)
    assert eng.state["k"].shape[2] == 128 and eng.state["k"].dtype == torch.int8
    rids = [eng.submit(p, b, temperature=t)
            for p, b, t in zip(rand_prompts(rng, (5, 20, 9)), (30, 12, 40), (0.0, 1.0, 0.0))]
    res = eng.run()
    for rid, b in zip(rids, (30, 12, 40)):
        assert len(res[rid].tokens) == b and all(0 <= t < 68 for t in res[rid].tokens)


def test_engine_requires_a_valid_draft_table():
    _, _, model, tcfg = make_pair()
    with pytest.raises(ValueError, match="draft_table"):
        ServingEngine(model, tcfg, slots=2, speculative_k=2, device="cpu")
    with pytest.raises(ValueError, match="draft_table shape"):
        spec_engine(model, tcfg, np.ones((8, 8)), slots=2)


def test_profile_drain_fits_the_benchmark_draft_table():
    """``profile_drain.fit_draft_table`` fits the bigram table to 8 sampled
    streams of min(256, block_size - 16) tokens after 16-id prompts, as
    ``scripts/benchmark_serving.py`` does; the same seed gives the same table."""
    from genomics_lm_torch.serving.profile_drain import fit_draft_table

    _, _, model, tcfg = make_pair()
    table = fit_draft_table(model, tcfg, seed=3)
    prompts = np.random.default_rng(3).integers(4, 68, (8, 16))
    stream = generate_tokens(model, tcfg, prompts, tcfg.block_size - 16,
                             torch.Generator().manual_seed(3), 1.0, device="cpu")
    np.testing.assert_array_equal(table, fit_bigram_table(list(stream.numpy()), 68))
    np.testing.assert_allclose(table.sum(1), 1.0, atol=1e-6)


def test_markov_corpus_matches_the_jax_script():
    """``benchmark_speculative``'s corpus is the JAX script's, and the
    transition matrix its entropy rate reads is the one that drew it."""
    from genomics_lm_torch.serving import benchmark_speculative as bench_spec
    from scripts.benchmark_speculative import markov_windows as jax_markov_windows

    X, Y = bench_spec.markov_windows(200, 64, 3)
    Xj, Yj = jax_markov_windows(200, 64, 3)
    assert np.array_equal(X, Xj) and np.array_equal(Y, Yj)
    trans = bench_spec.markov_transitions(3)
    np.testing.assert_allclose(trans.sum(axis=1), 1.0, rtol=1e-12)
    steps = trans[X[:, :-1] - 4, X[:, 1:] - 4]
    assert (steps > 1e-2).mean() > 0.97  # the windows walk the matrix's support
    assert 0.0 < bench_spec.markov_entropy_rate(trans) < np.log(4)


def test_offline_speculative_runs_without_autograd(monkeypatch):
    """``generate_tokens_speculative`` runs its forwards with autograd off
    (as ``generate_tokens`` does), in a cache of ``speculative_cache_size``
    positions."""
    from genomics_lm_torch.serving import speculative as tspec

    _, _, model, tcfg = make_pair()
    seen = []
    prefill = tspec.prefill

    def recording_prefill(*args, **kw):
        seen.append((torch.is_grad_enabled(), args[3]))
        return prefill(*args, **kw)

    monkeypatch.setattr(tspec, "prefill", recording_prefill)
    prompts = np.ones((2, 5), np.int64)
    table = fit_bigram_table(np.random.default_rng(0).integers(0, 68, 500), 68)
    tspec.generate_tokens_speculative(model, tcfg, prompts, 6, None, table, 3, 0.0,
                                      device="cpu")
    assert seen == [(False, tspec.speculative_cache_size(11, 3))]
    assert tspec.speculative_cache_size(11, 3) == 128
    assert tspec.speculative_cache_size(192, 4) == 256
