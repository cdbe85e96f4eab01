"""PyTorch port of cached generation against the JAX decode path.

``prefill`` logits and cache contents, ``decode_step`` logits (JAX with
``attention_impl="flash"`` runs its Pallas kernel in interpret mode; the
port runs the kernel's plain version on the CPU) and greedy
``generate_tokens`` — same weights, same prompts, float32 on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.generation import decode as jax_decode
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_torch.generation import decode as torch_decode
from genomics_lm_torch.generation.decode import (
    CachedDecoder,
    decode_step,
    generate_tokens,
    init_cache,
    next_token_logits,
    prefill,
)
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.decode_attention import decode_attention
from genomics_lm_torch.serving.engine import _ragged_decode, init_serving_state
from genomics_lm_torch.utils.weights import params_from_jax

ATOL = 1e-4


def make_pair(seed: int = 0, **over):
    kw = dict(vocab_size=68, block_size=96, n_layer=2, n_head=4, n_embd=64,
              dropout=0.0, sep_id=3, attention_impl="flash")
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return params, jcfg, model, tcfg


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_logits_and_cache_match_jax(kv_quant):
    params, jcfg, model, tcfg = make_pair(n_kv_head=2, use_rope=True)
    rng = np.random.default_rng(0)
    prompt = rng.integers(4, 68, (3, 12)).astype(np.int32)
    prompt[1, 5] = 3
    last = np.array([11, 6, 9], np.int32)
    jl, jc, _ = jax_decode.prefill(params, jcfg, jnp.asarray(prompt), 16, kv_quant,
                                   jnp.asarray(last), want_aux=False)
    tl, tc, aux = prefill(model, tcfg, prompt, 16, kv_quant, torch.from_numpy(last),
                          want_aux=False, device="cpu")
    assert aux == {}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for key in ("seg", "seg_count"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    if kv_quant:
        # an int8 code may differ by one step where a value sits on a rounding
        # edge; the dequantized cache agrees to one quantization step
        for key in ("k", "v"):
            deq = lambda c: (c[key].astype(np.float32).reshape(2, 3, 16, 2, 16)  # noqa: E731
                             * c[f"{key}_scale"].transpose(0, 1, 3, 2)[..., None])
            jcache = {n: np.asarray(jc[n]) for n in (key, f"{key}_scale")}
            tcache = {n: tc[n].numpy() for n in (key, f"{key}_scale")}
            np.testing.assert_allclose(deq(tcache), deq(jcache), atol=0.05)
    else:
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=1e-5)
    assert tc["length"] == int(jc["length"])


def test_prefill_scalar_last_index_sets_length_and_aux():
    params, jcfg, model, tcfg = make_pair(termination_aux=True, multi_offset_targets=(2,),
                                          tie_embeddings=False)
    prompt = np.random.default_rng(1).integers(4, 68, (2, 10)).astype(np.int32)
    jl, jc, ja = jax_decode.prefill(params, jcfg, jnp.asarray(prompt), None, False, 6)
    tl, tc, ta = prefill(model, tcfg, prompt, None, False, 6, device="cpu")
    assert tc["length"] == int(jc["length"]) == 7
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]), atol=ATOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_matches_jax_flash(kv_quant):
    """Three cached steps, one of them a <SEP>: logits agree with the JAX
    step running its Pallas kernel in interpret mode."""
    params, jcfg, model, tcfg = make_pair()
    prompt = np.random.default_rng(2).integers(4, 68, (3, 9)).astype(np.int32)
    jl, jc, _ = jax_decode.prefill(params, jcfg, jnp.asarray(prompt), None, kv_quant)
    tl, tc, _ = prefill(model, tcfg, prompt, None, kv_quant, device="cpu")
    for step in range(3):
        token = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        if step == 1:
            token[0] = 3
        jl, jc, _ = jax_decode.decode_step(params, jcfg, jc, jnp.asarray(token))
        tl, tc, _ = decode_step(model, tcfg, tc, token)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_array_equal(tc["seg"].numpy(), np.asarray(jc["seg"]))
    assert tc["length"] == int(jc["length"])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_generate_tokens_greedy_identical_to_jax(kv_quant):
    params, jcfg, model, tcfg = make_pair(use_rope=True, use_swiglu=True)
    prompt = np.random.default_rng(3).integers(4, 68, (2, 8)).astype(np.int32)
    want = np.asarray(jax_decode.generate_tokens(
        params, jcfg, jnp.asarray(prompt), 12, jax.random.PRNGKey(0), 0.0, kv_quant))
    got = generate_tokens(model, tcfg, prompt, 12, None, 0.0, kv_quant, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generation_is_seeded_and_in_range():
    _, _, model, tcfg = make_pair()
    prompt = np.random.default_rng(4).integers(4, 68, (3, 5))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return generate_tokens(model, tcfg, prompt, 10, gen, 1.0, device="cpu")

    a, b = draw(7), draw(7)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.shape == (3, 10) and int(a.min()) >= 0 and int(a.max()) < 68
    with pytest.raises(ValueError, match="block_size"):
        generate_tokens(model, tcfg, prompt, 92, device="cpu")


def test_cached_decoder_matches_uncached_forward():
    _, _, model, tcfg = make_pair(use_rope=True, termination_aux=True)
    dec = CachedDecoder(model, tcfg)
    ids = [1, 10, 20, 3, 30]
    for t in (40, 50, 3, 60):
        ids = ids + [t]
        got, aux = dec.next_logits(ids, return_aux=True)
        want, want_aux = next_token_logits(model, tcfg, ids, return_aux=True)
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(aux["termination_logits"],
                                   want_aux["termination_logits"], atol=ATOL)


def _step_above_1024_slots(model, tcfg, path, device):
    """One cached decode step over 1025 sequences, by ``path``."""
    B = 1025
    if path == "decode_step":
        prompt = np.random.default_rng(5).integers(4, 68, (B, 3))
        _, cache, _ = prefill(model, tcfg, prompt, 8, want_aux=False, device=device)
        return decode_step(model, tcfg, cache, np.full((B,), 7))[0]
    state = init_serving_state(tcfg, B, 8, device=device)
    state["active"][:] = True
    state["lengths"][:] = 2
    return _ragged_decode(model, tcfg, state, torch.full((B,), 7, device=device))[0]


@pytest.mark.parametrize("path", ["decode_step", "ragged"])
def test_flash_decode_has_no_batch_cap(monkeypatch, path):
    """Under ``flash`` a batch above 1024 goes through ``decode_attention``
    (the kernel for CUDA tensors, else a raise), never to the plain
    version behind the wrapper's back."""
    _, _, model, tcfg = make_pair()
    real = torch_decode.decode_attention
    batches = []

    def spy(q, *args, **kwargs):
        batches.append(q.shape[0])
        return real(q, *args, **kwargs)

    def plain(*args, **kwargs):
        raise AssertionError("flash decode took the plain version")

    monkeypatch.setattr(torch_decode, "decode_attention", spy)
    monkeypatch.setattr(torch_decode, "decode_attention_reference", plain)
    logits = _step_above_1024_slots(model, tcfg, path, "cpu")
    assert batches == [1025] * tcfg.n_layer
    assert logits.shape == (1025, tcfg.vocab_size) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("path", ["decode_step", "ragged"])
def test_cuda_flash_decode_launches_kernel_above_1024_slots(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, _, model, tcfg = make_pair()
    before = decode_attention.launches
    _step_above_1024_slots(model.to("cuda"), tcfg, path, "cuda")
    assert decode_attention.launches - before == tcfg.n_layer


def test_entry_points_need_a_device_without_cuda():
    """No hidden fallback: without CUDA the default-device entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    _, _, model, tcfg = make_pair()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_tokens(model, tcfg, [[1, 4, 5]], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefill(model, tcfg, [[1, 4, 5]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(tcfg)
