"""PyTorch port of the mixture-of-experts CodonGPT against the JAX package.

The same numpy weights and inputs go through ``genomics_lm_tpu``'s
``_moe_mlp``, ``forward``, train step, decoders, engines, quantization,
LoRA and trainer and through the port's on the CPU (2 layers, d 16–64,
float32). Tolerances: the MoE output within 1e-5 and the router loss
within 1e-6 (float32 sums in different orders); the dropped (token, rank)
pairs and the experts chosen on an exact tie equal; logits within 1e-4;
gradients within 1e-5 relative; the cached decode within 2e-4 of the
uncached forward (JAX's own gate); greedy tokens equal; quantized attention
bit-equal; remat bit-equal; per-epoch trainer losses within 1e-5 relative.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genomics_lm_tpu.generation import decode as jax_decode
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.ops import quant as jax_quant
from genomics_lm_tpu.serving import engine as jax_engine
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_tpu.training import lora as jax_lora
from genomics_lm_tpu.training import train_step as jax_step
from genomics_lm_tpu.training.loop import run_training as jax_run_training
from genomics_lm_torch.generation.decode import CachedDecoder, next_token_logits
from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.codon_gpt import CodonGPT, attach_lora, moe_route
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.quant import quantize_params
from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.serving.speculative import fit_bigram_table
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training import lora
from genomics_lm_torch.training.loop import run_training
from genomics_lm_torch.training.optim import _factored_dims, build_optimizer
from genomics_lm_torch.training.train_step import LossConfig, composite_loss
from genomics_lm_torch.utils.weights import jax_leaves, params_from_jax, params_to_jax

Y_ATOL, AUX_ATOL, LOGIT_ATOL, GRAD_RTOL, CURVE_RTOL = 1e-5, 1e-6, 1e-4, 1e-5, 1e-5


def make_pair(seed: int = 0, **over):
    kw = dict(vocab_size=68, block_size=64, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
              sep_id=3, moe_experts=4, moe_top_k=2)
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return params, jcfg, model, tcfg


def layer0(params):
    return jax.tree.map(lambda p: p[0], params["blocks"])


def jax_routing(block_p, cfg, h, capped):
    """JAX ``_moe_mlp``'s routing (``codon_gpt.py:306-329``): top-k experts
    and the slot of each (token, rank) choice, with the capacity."""
    B, T, D = h.shape
    N, E, k = B * T, cfg.moe_experts, min(cfg.moe_top_k, cfg.moe_experts)
    C = math.ceil(cfg.moe_capacity_factor * k * N / E) if capped else N
    probs = jax.nn.softmax(jnp.asarray(h, jnp.float32).reshape(N, D) @ block_p["router"]["w"])
    _, gate_idx = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = oh.transpose(1, 0, 2).reshape(k * N, E)
    pos = (jnp.cumsum(flat, axis=0) - flat).reshape(k, N, E).transpose(1, 0, 2)
    pos = jnp.sum(pos * oh, axis=-1)
    return np.asarray(gate_idx), np.asarray(pos), max(1, C)


def hidden(seed, B=3, T=20, D=32):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu", "swiglu"])
@pytest.mark.parametrize("capped", [True, False], ids=["capped", "dropless"])
def test_moe_mlp_matches_jax(swiglu, capped):
    """Capacity 0.5: half the choices drop, so a wrong slot priority shows."""
    params, jcfg, model, tcfg = make_pair(use_swiglu=swiglu, moe_capacity_factor=0.5)
    h = hidden(1)
    want_y, want_aux = jax_gpt._moe_mlp(layer0(params), jcfg, h, capped=capped)
    with torch.no_grad():
        y, aux = codon_gpt._moe_mlp(model.blocks[0], tcfg, torch.from_numpy(h), capped=capped)
        r = moe_route(model.blocks[0], tcfg, torch.from_numpy(h).reshape(-1, 32),
                      capped=capped)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=Y_ATOL)
    assert abs(float(aux) - float(want_aux)) <= AUX_ATOL
    gate_idx, pos, C = jax_routing(layer0(params), jcfg, h, capped)
    assert r["C"] == C
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    dropped = ~r["keep"].numpy()
    np.testing.assert_array_equal(dropped, pos >= C)
    assert dropped.any() == capped and (~dropped).any()
    # a token whose every choice dropped passes through: its MLP output is 0
    none_kept = dropped.all(axis=1)
    assert (y.reshape(-1, 32).numpy()[none_kept] == 0).all()


def test_exact_tie_picks_jax_experts():
    """Router columns 1 = 2 and 0 = 3 = -column 1: every token's two leading
    experts tie exactly (1 and 2 where its column-1 logit is positive, else
    0 and 3), and the lower index wins, as ``jax.lax.top_k`` orders ties."""
    params, jcfg, model, tcfg = make_pair(moe_top_k=1)
    params = jax.tree.map(lambda x: x, params)
    w = np.asarray(params["blocks"]["router"]["w"]).copy()
    w[:, :, 2] = w[:, :, 1]
    w[:, :, 0] = w[:, :, 3] = -w[:, :, 1]
    params["blocks"]["router"]["w"] = jnp.asarray(w)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    h = hidden(2)
    gate_idx, _, _ = jax_routing(layer0(params), jcfg, h, capped=True)
    with torch.no_grad():
        r = moe_route(model.blocks[0], tcfg, torch.from_numpy(h).reshape(-1, 32), capped=True)
        y, _ = codon_gpt._moe_mlp(model.blocks[0], tcfg, torch.from_numpy(h), capped=True)
    assert (r["probs"][:, 1] == r["probs"][:, 2]).all()
    assert (r["probs"][:, 0] == r["probs"][:, 3]).all()
    lead1 = (h.reshape(-1, 32) @ w[0, :, 1]) > 0
    assert lead1.any() and (~lead1).any()
    np.testing.assert_array_equal(gate_idx[:, 0], np.where(lead1, 1, 0))
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    want_y, _ = jax_gpt._moe_mlp(layer0(params), jcfg, h, capped=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=Y_ATOL)


def test_bf16_router_runs_in_float32():
    """Under bf16 compute the router multiplies the float32 upcast of the
    bf16 tokens by the float32 router, as JAX does; a bf16 router would
    round the logits and could change expert choices."""
    params, jcfg, model, tcfg = make_pair(compute_dtype="bfloat16")
    h = torch.from_numpy(hidden(3)).to(torch.bfloat16)
    with torch.no_grad():
        r = moe_route(model.blocks[0], tcfg, h.reshape(-1, 32), capped=True)
        y, _ = codon_gpt._moe_mlp(model.blocks[0], tcfg, h, capped=True)
    assert r["probs"].dtype == torch.float32 and y.dtype == torch.bfloat16
    want = torch.softmax(h.reshape(-1, 32).float() @ model.blocks[0].router.w, dim=-1)
    assert torch.equal(r["probs"], want)
    gate_idx, pos, _ = jax_routing(layer0(params), jcfg, jnp.asarray(h.float().numpy(),
                                                                     jnp.bfloat16), True)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)


def ids(seed, B=2, T=40):
    x = np.random.default_rng(seed).integers(4, 68, (B, T)).astype(np.int32)
    x[:, 0] = 1
    x[0, T // 2] = 3
    return x


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_logits_and_aux_match_jax(train):
    params, jcfg, model, tcfg = make_pair(moe_capacity_factor=0.5)
    x = ids(4)
    want, _, want_aux = jax_gpt.forward(params, jcfg, x, train=train, return_aux=True)
    with torch.no_grad():
        got, _, aux = codon_gpt.forward(model, tcfg, torch.from_numpy(x).long(), train=train,
                                        return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    assert abs(float(aux["moe_aux_loss"]) - float(want_aux["moe_aux_loss"])) <= AUX_ATOL


def grads_by_leaf(model, cfg):
    return {leaf.path: leaf.gather(lambda p: p.grad).numpy()
            for leaf in jax_leaves(model, cfg)}


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_gradients_match_jax_and_reach_every_expert():
    params, jcfg, model, tcfg = make_pair(moe_capacity_factor=0.5, label_smoothing=0.05)
    x = ids(5, B=4, T=32)
    y = np.roll(x, -1, axis=1)

    def loss_fn(p):
        total, _ = jax_step.composite_loss(p, jcfg, jax_step.LossConfig(), x, y,
                                           train=True, rng=None)
        return total

    want = flat_tree(jax.grad(loss_fn)(params))
    total, parts = composite_loss(model.train(), tcfg, LossConfig(), torch.from_numpy(x).long(),
                                  torch.from_numpy(y).long(), train=True, generator=None)
    total.backward()
    got = grads_by_leaf(model, tcfg)
    assert set(got) == set(want)
    # the key bias's gradient is zero in exact arithmetic (softmax ignores a
    # shift shared by all keys) and rounding noise here: each leaf is held to
    # the larger of its own max and a thousandth of the model's max
    floor = 1e-3 * max(np.abs(g).max() for g in want.values())
    for path, g in want.items():
        err = np.abs(got[path] - g).max() / max(np.abs(g).max(), floor)
        assert err <= GRAD_RTOL, f"{path}: {err}"
    assert np.abs(got["blocks/router/w"]).max() > 0
    per_expert = np.abs(got["blocks/mlp/fc/w"]).reshape(2 * 4, -1).max(axis=1)
    assert (per_expert > 0).all()


def test_remat_is_bit_equal():
    _, _, model, tcfg = make_pair(dropout=0.1)
    x = torch.from_numpy(ids(6, B=2, T=32)).long()
    out = {}
    for remat in (False, True):
        cfg = tcfg.replace(use_checkpoint=remat)
        model.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(3)
        _, loss, aux = codon_gpt.forward(model, cfg, x, x.roll(-1, 1), train=True,
                                         generator=gen, return_aux=True)
        (loss + 0.01 * aux["moe_aux_loss"]).backward()
        out[remat] = (float(loss.detach()), float(aux["moe_aux_loss"].detach()),
                      [p.grad.clone() for p in model.parameters()])
    assert out[False][:2] == out[True][:2]
    assert all(torch.equal(a, b) for a, b in zip(out[False][2], out[True][2]))


def test_cached_decoder_matches_uncached():
    _, _, model, tcfg = make_pair(block_size=32)
    rng = np.random.default_rng(0)
    seq = [1] + [int(t) for t in rng.integers(4, 68, 10)]
    seq.insert(5, 3)
    decoder = CachedDecoder(model, tcfg)
    for t in range(3, len(seq) + 1):
        cached = np.asarray(decoder.next_logits(seq[:t]))
        with torch.no_grad():
            uncached = np.asarray(next_token_logits(model, tcfg, seq[:t]))
        np.testing.assert_allclose(cached, uncached, atol=2e-4)


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "speculative"])
def test_engine_greedy_matches_jax_engine(speculative):
    params, jcfg, model, tcfg = make_pair(n_embd=32, fused_qkv=True, attention_impl="flash")
    rng = np.random.default_rng(7)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, n)], m)
            for n, m in ((5, 12), (11, 7), (17, 10))]
    reqs[1][0][4] = 3
    kw = dict(slots=2, steps_per_sync=3)
    if speculative:
        kw.update(speculative_k=3, draft_table=fit_bigram_table(rng.integers(0, 68, 4000), 68))

    def drain(eng):
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    want = drain(jax_engine.ServingEngine(params, jcfg, **kw))
    assert drain(ServingEngine(model, tcfg, device="cpu", **kw)) == want


def test_quantize_params_attention_bit_equal_experts_float32():
    params, jcfg, model, tcfg = make_pair()
    want = flat_tree(jax_quant.quantize_params(params))
    got = flat_tree(params_to_jax(quantize_params(model), tcfg))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    assert "blocks/attn/query/w_q" in got and got["blocks/mlp/fc/w"].dtype == np.float32
    assert got["blocks/router/w"].dtype == np.float32


def test_weights_round_trip_and_leftover_leaves_raise():
    params, jcfg, model, tcfg = make_pair(use_swiglu=True)
    tree = jax.tree.map(np.asarray, params)
    back = flat_tree(params_to_jax(model, tcfg))
    want = flat_tree(tree)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    assert back["blocks/mlp/w_gate/w"].shape == (2, 4, 32, tcfg.mlp_hidden)
    assert back["blocks/router/w"].shape == (2, 32, 4)
    dense = tcfg.replace(moe_experts=0)
    with pytest.raises(ValueError, match="blocks/router/w"):  # a router beside a dense MLP
        params_from_jax(tree, dense, "cpu")
    no_router = {**tree, "blocks": {k: v for k, v in tree["blocks"].items() if k != "router"}}
    with pytest.raises(ValueError, match="blocks/mlp/w_gate/w"):  # experts, no router
        params_from_jax(no_router, dense, "cpu")
    with pytest.raises(KeyError, match="router"):
        params_from_jax(no_router, tcfg, "cpu")


def test_lora_attaches_to_attention_and_refuses_experts():
    params, _, model, tcfg = make_pair()
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="MoE"):
        lora.add_lora_adapters(tree, np.random.default_rng(0), rank=2, targets="attn+mlp")
    with pytest.raises(ValueError, match="MoE"):
        jax_lora.add_lora_adapters(params, jax.random.PRNGKey(0), rank=2, targets="attn+mlp")
    with pytest.raises(ValueError, match="MoE"):
        attach_lora(model, [("attn", "query"), ("mlp", "fc")], 2)
    adapted = lora.add_lora_adapters(tree, np.random.default_rng(0), rank=2)
    loaded = params_from_jax(adapted, tcfg, "cpu")
    assert loaded.blocks[0].attn.query.lora.lora_a.shape == (32, 2)
    x = torch.from_numpy(ids(8)).long()
    with torch.no_grad():  # lora_b = 0: the adapted model is the base model
        assert torch.equal(codon_gpt.forward(loaded, tcfg, x)[0],
                           codon_gpt.forward(model, tcfg, x)[0])


def test_adafactor_factors_the_expert_leaves_as_optax():
    """The stacked expert leaves (L, E, D, H) factor over their two largest
    axes; the router (L, D, E) and the expert biases stay unfactored."""
    from optax._src import factorized

    shapes = [(12, 4, 512, 2048), (12, 4, 2048, 512), (12, 4, 2048), (12, 512, 4),
              (12, 4, 512), (2, 4, 32, 128)]
    for shape in shapes:
        want = factorized._factored_dims(shape, True, 128)
        got = _factored_dims(shape)
        assert (got is None and want is None) or tuple(got) == tuple(want), shape
    _, _, model, tcfg = make_pair(n_embd=128)
    bundle = build_optimizer({"lr": 1e-3, "optimizer": "adafactor"}, model, 10)
    state = bundle.optimizer.state
    assert set(state["blocks/mlp/fc/w"]) == {"v_row", "v_col"}
    assert state["blocks/mlp/fc/w"]["v_row"].shape == (2, 4, 128)
    assert set(state["blocks/router/w"]) == {"v"}
    labels = {n: l for n, l in bundle.labels.items() if "mlp" in n or "router" in n}
    assert labels and set(labels.values()) == {"base"}


def write_corpus(tmp_path):
    rng = np.random.default_rng(7)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", 64), ("val", 16)):
        X = np.zeros((n, 16), np.int32)
        X[:, 0] = rng.integers(4, 68, n)
        for t in range(1, 16):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        X[:, ::7] = 3
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 2
        Y[:8, -3:] = 0  # pad tails count in the router loss
        np.savez(tmp_path / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp_path / "itos.txt")
    return {"train_npz": str(tmp_path / "train.npz"), "val_npz": str(tmp_path / "val.npz"),
            "block_size": 16, "n_layer": 2, "n_head": 2, "n_embd": 16, "dropout": 0.0,
            "label_smoothing": 0.05, "batch_size": 8, "grad_accum_steps": 2, "lr": 1e-3,
            "min_lr": 1e-4, "warmup_steps": 1, "epochs": 2, "seed": 1, "moe_experts": 4,
            "moe_top_k": 2, "moe_capacity_factor": 0.5, "moe_aux_weight": 0.01,
            "shard_optimizer_state": True, "early_stop_patience": 0, "save_epochs": True}


def test_moe_trainer_tracks_jax_and_resumes(tmp_path):
    cfg = write_corpus(tmp_path)
    jcfg = JaxConfig.from_run_config(dict(cfg, vocab_size=68))
    init = tmp_path / "init.npz"
    jckpt.save_checkpoint({"model": jax_gpt.init(jax.random.PRNGKey(5), jcfg)}, init)
    runs = tmp_path / "runs"
    jax_run_training(dict(cfg, run_id="jax-moe"), transfer_from=str(init), run_root=runs)
    tmeta = run_training(dict(cfg, run_id="port-moe"), transfer_from=str(init), run_root=runs,
                         device="cpu")
    assert tmeta["status"] == "completed"
    for epoch in (1, 2):
        jp = jckpt.load_checkpoint(runs / "jax-moe" / "checkpoints" / f"epoch_{epoch}.npz")
        tp = tckpt.load_checkpoint(runs / "port-moe" / "checkpoints" / f"epoch_{epoch}.npz")
        for key in ("train_loss", "val_loss", "train_next_loss", "val_next_loss"):
            err = abs(tp[key] - jp[key]) / abs(jp[key])
            assert err <= CURVE_RTOL, f"epoch {epoch} {key}: {err}"
        assert tp["train_loss"] != tp["train_next_loss"]  # the router loss trains
    last = runs / "port-moe" / "checkpoints" / "last.npz"
    by_jax = jckpt.load_checkpoint(last)
    assert by_jax["model"]["blocks"]["router"]["w"].shape == (2, 16, 4)
    x = np.load(tmp_path / "val.npz")["X"][:4]
    want, _ = jax_gpt.forward(jax.tree.map(jnp.asarray, by_jax["model"]), jcfg, jnp.asarray(x))
    tcfg = CodonGPTConfig.from_run_config(dict(by_jax["cfg"], vocab_size=68))
    with torch.no_grad():
        got, _ = codon_gpt.forward(params_from_jax(tckpt.load_checkpoint(last)["model"], tcfg,
                                                   "cpu"), tcfg, torch.from_numpy(x).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    meta = run_training(dict(cfg, run_id="port-moe", epochs=3), resume=str(last),
                        run_root=runs, device="cpu")
    assert meta["status"] == "completed" and meta["last_epoch"] == 3


def test_param_count_of_the_stage2_6_config():
    """The shipped MoE config's parameters, counted without building it."""
    import yaml
    from pathlib import Path

    run = yaml.safe_load((Path(__file__).resolve().parents[1] / "configs"
                          / "stage2.6_moe_4e_top2_d512_ep2.yaml").read_text())
    cfg = CodonGPTConfig.from_run_config(dict(run, vocab_size=68))
    with torch.device("meta"):
        moe, dense = CodonGPT(cfg), CodonGPT(cfg.replace(moe_experts=0))
    assert codon_gpt.param_count(moe) == 113_740_800
    assert codon_gpt.param_count(dense) == 38_126_592
    shapes = jax.eval_shape(lambda: jax_gpt.init(jax.random.PRNGKey(0),
                                                 JaxConfig.from_run_config(dict(run, vocab_size=68))))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 113_740_800


def test_profile_split_attributes_forward_and_backward_to_each_part():
    """``profile_step.moe_device_split`` gives every MoE part its forward
    range and the backward of the operations run inside it (autograd
    sequence numbers), read here by CPU time: the card's profile reads
    kernel time the same way."""
    from genomics_lm_torch.training.profile_step import moe_device_split

    _, _, model, tcfg = make_pair()
    x = torch.from_numpy(ids(9)).long()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, loss, aux = codon_gpt.forward(model.train(), tcfg, x, x.roll(-1, 1), train=True,
                                         return_aux=True)
        (loss + aux["moe_aux_loss"]).backward()
    split = moe_device_split(prof.events(), time_of=lambda e: float(e.cpu_time_total))
    assert set(split) == {"router", "dispatch", "experts", "combine"}
    for part, times in split.items():
        assert times["forward_us"] > 0 and times["backward_us"] > 0, part
