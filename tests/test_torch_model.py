"""PyTorch port of CodonGPT: the forward against the JAX model.

The same numpy weights (``jax.tree.map(np.asarray, params)``) and the
same token ids go through ``genomics_lm_tpu.models.codon_gpt.forward`` and
the port's ``forward`` on the CPU. Logits and the auxiliary heads must
agree to 1e-4 and the loss to 1e-5 (float32; the two frameworks sum in
different orders).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_torch.models.codon_gpt import CodonGPT, forward
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.utils.weights import params_from_jax, state_dict_from_jax

ATOL = 1e-4

VARIANTS = {
    "learned_pos_gelu_mha": {},
    "rope_swiglu": {"use_rope": True, "use_swiglu": True},
    "gqa_fused_qkv": {"n_kv_head": 2, "fused_qkv": True},
    "gqa_rope_unfused": {"n_kv_head": 1, "use_rope": True},
    "untied_aux_heads": {"tie_embeddings": False, "termination_aux": True,
                         "multi_offset_targets": (1, 3)},
    "no_sep_swiglu_fused": {"sep_id": None, "use_swiglu": True, "fused_qkv": True},
}


def make_pair(seed: int = 0, **over):
    kw = dict(vocab_size=68, block_size=96, n_layer=2, n_head=4, n_embd=64,
              dropout=0.0, sep_id=3)
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return params, jcfg, model, tcfg


def make_ids(rng, B, T):
    idx = rng.integers(4, 68, (B, T)).astype(np.int32)
    idx[:, 0] = 1
    idx[0, T // 2] = 3  # a <SEP> mid-row: segment masking is exercised
    return idx


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    params, jcfg, model, tcfg = make_pair(**VARIANTS[variant])
    idx = make_ids(np.random.default_rng(1), 3, 40)
    want_logits, _, want_aux = jax_gpt.forward(params, jcfg, idx, return_aux=True)
    with torch.no_grad():  # the inference forward, as serving runs it
        logits, loss, aux = forward(model, tcfg, torch.from_numpy(idx), return_aux=True)
    assert loss is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL)
    assert set(aux) == set(want_aux)
    if tcfg.termination_aux:
        np.testing.assert_allclose(aux["termination_logits"].numpy(),
                                   np.asarray(want_aux["termination_logits"]), atol=ATOL)
    for o, want in want_aux.get("offset_logits", {}).items():
        np.testing.assert_allclose(aux["offset_logits"][o].numpy(), np.asarray(want),
                                   atol=ATOL)


def test_module_call_and_bf16_forward_track_f32():
    """``CodonGPT.__call__`` is the functional forward; the bf16 compute path
    stays within bf16 rounding of the f32 logits."""
    params, jcfg, model, tcfg = make_pair(seed=2)
    idx = torch.from_numpy(make_ids(np.random.default_rng(2), 2, 24))
    with torch.no_grad():
        f32, _ = model(idx)
        np.testing.assert_array_equal(f32.numpy(), forward(model, tcfg, idx)[0].numpy())
        bf16, _ = forward(model, tcfg.replace(compute_dtype="bfloat16"), idx)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), atol=0.25)


def test_state_dict_keys_follow_reference_layout():
    _, _, model, tcfg = make_pair(tie_embeddings=False)
    keys = set(model.state_dict())
    for k in ("tok_emb.weight", "pos_emb.weight", "blocks.1.attn.query.weight",
              "blocks.0.mlp.0.weight", "blocks.0.mlp.2.bias", "ln_f.weight",
              "head.weight"):
        assert k in keys
    _, _, fused, _ = make_pair(fused_qkv=True)
    assert "blocks.0.attn.qkv.weight" in fused.state_dict()
    assert fused.state_dict()["blocks.0.attn.qkv.weight"].shape == (3 * 64, 64)


def test_fresh_module_init_matches_jax_distributions():
    """A seeded ``CodonGPT(cfg)`` draws from the JAX ``init`` distributions."""
    cfg = CodonGPTConfig(vocab_size=68, block_size=96, n_layer=2, n_head=4, n_embd=64,
                         multi_offset_targets=(1,))
    torch.manual_seed(0)
    model = CodonGPT(cfg)
    w = model.blocks[0].mlp[0].weight.detach()
    assert float(w.abs().max()) <= 1.0 / 8.0  # U(±1/√fan_in), fan_in 64
    assert abs(float(model.tok_emb.weight.detach().std()) - 1.0) < 0.1
    torch.testing.assert_close(model.offset_projs["1"][0].weight, torch.eye(64))


def test_config_fields_and_run_config_match_jax():
    run = {"vocab_size": 68, "block_size": 512, "n_layer": 10, "n_head": 8,
           "n_embd": 384, "fused_qkv": True, "compute_dtype": "bfloat16",
           "attention_impl": "flash", "n_kv_head": 2, "multi_offset_targets": [3, 1]}
    jcfg, tcfg = JaxConfig.from_run_config(run), CodonGPTConfig.from_run_config(run)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jcfg.to_dict() == tcfg.to_dict()
    assert (tcfg.head_dim, tcfg.kv_heads, tcfg.mlp_hidden) == (48, 2, 1536)
    assert tcfg.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        CodonGPTConfig(vocab_size=68, block_size=8, n_head=3, n_embd=64)
    with pytest.raises(ValueError):
        CodonGPTConfig(vocab_size=68, block_size=8, compute_dtype="int4").dtype


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError):
        CodonGPT(CodonGPTConfig(vocab_size=68, block_size=8, n_embd=64, moe_experts=4))
    params, jcfg, _, tcfg = make_pair()
    tree = jax.tree.map(np.asarray, params)
    lora = dict(tree)
    lora["blocks"] = dict(tree["blocks"], attn=dict(
        tree["blocks"]["attn"],
        query=dict(tree["blocks"]["attn"]["query"], lora_a=np.zeros((2, 64, 4)))))
    with pytest.raises(NotImplementedError):
        state_dict_from_jax(lora, tcfg)
    from genomics_lm_tpu.ops.quant import quantize_params

    with pytest.raises(NotImplementedError):
        state_dict_from_jax(jax.tree.map(np.asarray, quantize_params(params)), tcfg)


LOSS_CASES = {
    "plain": {},
    "smoothing": {"label_smoothing": 0.05},
    "smoothing_weights": {"label_smoothing": 0.1,
                          "loss_weights": tuple(0.5 + (i % 3) * 0.5 for i in range(68))},
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_forward_loss_matches_jax(case):
    """``forward(..., targets)`` gives JAX's loss, pads (id 0) ignored."""
    params, jcfg, model, tcfg = make_pair(**LOSS_CASES[case])
    rng = np.random.default_rng(3)
    idx = make_ids(rng, 3, 40)
    targets = np.roll(idx, -1, axis=1)
    targets[:, -1] = 2
    targets[1, -6:] = 0
    _, want = jax_gpt.forward(params, jcfg, idx, targets)
    logits, loss = forward(model, tcfg, torch.from_numpy(idx), torch.from_numpy(targets))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)


def test_flash_impl_matches_xla_and_drops_like_it():
    """``attention_impl="flash"`` runs the flash op (its plain version on the
    CPU): the same logits as the einsum path, and in training the same
    dropout, since both paths draw from one Philox stream and one generator."""
    _, _, model, tcfg = make_pair(dropout=0.2)
    idx = torch.from_numpy(make_ids(np.random.default_rng(4), 2, 48))
    flash_cfg = tcfg.replace(attention_impl="flash")
    xla, _ = forward(model, tcfg, idx)
    flash, _ = forward(model, flash_cfg, idx)
    np.testing.assert_allclose(flash.detach().numpy(), xla.detach().numpy(), atol=ATOL)

    def train_logits(cfg, seed):
        gen = torch.Generator().manual_seed(seed)
        return forward(model, cfg, idx, train=True, generator=gen)[0].detach().numpy()

    np.testing.assert_allclose(train_logits(flash_cfg, 5), train_logits(tcfg, 5), atol=ATOL)
    assert not np.allclose(train_logits(flash_cfg, 5), flash.detach().numpy(), atol=1e-2)
    # without a generator, train=True drops nothing, as JAX without a key
    np.testing.assert_array_equal(
        forward(model, flash_cfg, idx, train=True)[0].detach().numpy(),
        flash.detach().numpy())
