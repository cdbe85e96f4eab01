"""PyTorch port of weight-only int8 serving against the JAX package.

``ops/quant.py::quantize_weight`` and ``quantize_params`` must give JAX's
int8 weights and float32 scales bit for bit from the same float32 weights
(fused and split QKV); a JAX-quantized tree loads into the port as the
port's own quantization of the dense model, and ``params_to_jax`` writes
it back exactly. Int8 logits match JAX's int8 ``forward`` within 1e-5 of
the largest logit, and greedy int8 serving (plain and speculative, bf16 or
int8 cache) emits JAX's engine's tokens. The refusals hold: an unmerged
LoRA model and LoRA on int8 weights; a quantized MoE tree loads with its
experts float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.ops import quant as jax_quant
from genomics_lm_tpu.serving import engine as jax_engine
from genomics_lm_tpu.training import lora as jax_lora
from genomics_lm_torch.models.codon_gpt import Int8Linear, attach_lora, forward
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.quant import (
    dequantize_weight,
    quantize_params,
    quantize_weight,
)
from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.training import lora
from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax

# float32 on both sides, summed in different orders: logits of order 10-50
# differ by ~1e-7 of their size; a wrong scale or row moves them by order 1
LOGIT_RTOL = 1e-5

VARIANTS = {
    "gelu": {},
    "swiglu": {"use_swiglu": True},
    "fused_qkv": {"fused_qkv": True},
    "gqa_fused_rope": {"n_kv_head": 2, "fused_qkv": True, "use_rope": True},
    "gqa_split_swiglu": {"n_kv_head": 1, "use_swiglu": True},
}


def make_pair(seed: int = 0, **over):
    kw = dict(vocab_size=68, block_size=64, n_layer=2, n_head=4, n_embd=48,
              dropout=0.0, sep_id=3)
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    return params, jcfg, tcfg


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_quantize_weight_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)  # JAX layout (L, in, out)
    w[1, :, 5] = 0.0  # a dead channel: amax floored at 1e-8
    # exact halves after the division (scale 1): round half to even
    w[2, :4, 7] = [127.0, 2.5, -3.5, 0.5]
    w[2, 4:, 7] = 0.0
    want = jax_quant.quantize_weight(jnp.asarray(w))
    w_q, scale = quantize_weight(torch.from_numpy(w).transpose(-1, -2))
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w_q.transpose(-1, -2).numpy(), np.asarray(want["w_q"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"]))
    assert w_q[2, 7, :4].tolist() == [127, 2, -4, 0]
    np.testing.assert_array_equal(
        dequantize_weight(w_q, scale).transpose(-1, -2).numpy(),
        np.asarray(jax_quant.dequantize_weight(want)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_quantize_params_is_bit_equal_to_jax(variant):
    """The port's quantization of the dense model, JAX's quantized tree
    loaded into the port and written back: every leaf equal, int8 stays
    int8. A fused QKV's rows are JAX's three projections quantized apart."""
    params, _, tcfg = make_pair(**VARIANTS[variant])
    jq = np_tree(jax_quant.quantize_params(params))
    ported = quantize_params(params_from_jax(np_tree(params), tcfg, "cpu"))
    loaded = params_from_jax(jq, tcfg, "cpu")
    want = flat(jq)
    for model in (ported, loaded):
        got = flat(params_to_jax(model, tcfg))
        assert sorted(got) == sorted(want)
        for path, value in want.items():
            assert got[path].dtype == value.dtype, path
            np.testing.assert_array_equal(got[path], value, err_msg=path)
    sd_p, sd_l = ported.state_dict(), loaded.state_dict()
    assert sorted(sd_p) == sorted(sd_l)
    for key in sd_p:
        assert torch.equal(sd_p[key], sd_l[key]), key


def test_int8_model_drops_the_dense_weights():
    params, _, tcfg = make_pair(fused_qkv=True)
    model = quantize_params(params_from_jax(np_tree(params), tcfg, "cpu"))
    for block in model.blocks:
        for lin in (block.attn.qkv, block.attn.proj, block.mlp[0], block.mlp[2]):
            assert isinstance(lin, Int8Linear) and not hasattr(lin, "weight")
    dense = params_from_jax(np_tree(params), tcfg, "cpu")
    D, H = tcfg.n_embd, tcfg.mlp_hidden
    weights = tcfg.n_layer * (D * 3 * D + D * D + 2 * D * H)
    block_bytes = lambda m: sum(p.numel() * p.element_size()  # noqa: E731
                                for n, p in m.named_parameters()
                                if n.startswith("blocks.") and n.endswith(("weight", "w_q"))
                                and ".ln" not in n)
    assert block_bytes(dense) == 4 * weights
    assert block_bytes(model) == weights
    assert model.tok_emb.weight.dtype == torch.float32


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_int8_logits_match_jax(variant):
    params, jcfg, tcfg = make_pair(**VARIANTS[variant])
    jq = jax_quant.quantize_params(params)
    model = params_from_jax(np_tree(jq), tcfg, "cpu")
    rng = np.random.default_rng(1)
    idx = rng.integers(4, 68, (2, 40)).astype(np.int32)
    idx[:, 0] = 1
    idx[0, 17] = 3
    want, _ = jax_gpt.forward(jq, jcfg, jnp.asarray(idx))
    with torch.no_grad():
        got, _ = forward(model, tcfg, torch.from_numpy(idx).long())
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())
    assert err <= LOGIT_RTOL, err


@pytest.mark.parametrize("kv_quant", [False, True])
def test_int8_greedy_serving_matches_jax_engine(kv_quant):
    params, jcfg, tcfg = make_pair(n_kv_head=2, fused_qkv=True, attention_impl="flash")
    jq = jax_quant.quantize_params(params)
    model = quantize_params(params_from_jax(np_tree(params), tcfg, "cpu"))
    rng = np.random.default_rng(2)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, n)], b)
            for n, b in ((5, 12), (11, 7), (17, 10), (3, 9))]
    reqs[1][0][4] = 3

    def drain(eng):
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    want = drain(jax_engine.ServingEngine(jq, jcfg, slots=2, steps_per_sync=4,
                                          kv_quant=kv_quant))
    assert drain(ServingEngine(model, tcfg, slots=2, steps_per_sync=4, kv_quant=kv_quant,
                               device="cpu")) == want
    spec = ServingEngine(model, tcfg, slots=2, steps_per_sync=4, kv_quant=kv_quant,
                         speculative_k=3, draft_table=np.full((68, 68), 1 / 68),
                         device="cpu")
    assert drain(spec) == want


def test_refusals():
    params, _, tcfg = make_pair()
    # an unmerged LoRA model would lose its adapters
    adapted = params_from_jax(np_tree(jax_lora.add_lora_adapters(
        params, jax.random.PRNGKey(1), rank=2)), tcfg, "cpu")
    with pytest.raises(ValueError, match="unmerged LoRA"):
        quantize_params(adapted)
    # LoRA on int8 weights: on the module and on the checkpoint tree
    model = quantize_params(params_from_jax(np_tree(params), tcfg, "cpu"))
    with pytest.raises(ValueError, match="int8"):
        attach_lora(model, [("attn", "query")], 2)
    with pytest.raises(ValueError, match="int8"):
        lora.add_lora_adapters(params_to_jax(model, tcfg), np.random.default_rng(0), rank=2)
    # a leaf with no place still raises: a dense weight beside the int8 one
    stray = np_tree(jax_quant.quantize_params(params))
    stray["blocks"]["attn"]["proj"]["w"] = np.zeros((2, 48, 48), np.float32)
    with pytest.raises(ValueError, match="blocks/attn/proj/w"):
        params_from_jax(stray, tcfg, "cpu")
    # a quantized MoE tree loads under its MoE config, and under a dense one
    # its router has no place
    moe = jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(
        vocab_size=68, block_size=16, n_layer=1, n_head=2, n_embd=16, moe_experts=2))
    dense_cfg = CodonGPTConfig(vocab_size=68, block_size=16, n_layer=1, n_head=2, n_embd=16)
    with pytest.raises(ValueError, match="blocks/router/w"):
        params_from_jax(np_tree(jax_quant.quantize_params(moe)), dense_cfg, "cpu")
    loaded = params_from_jax(np_tree(jax_quant.quantize_params(moe)),
                             dense_cfg.replace(moe_experts=2), "cpu")
    assert isinstance(loaded.blocks[0].attn.query, Int8Linear)
    assert loaded.blocks[0].mlp.fc.w.dtype == torch.float32
