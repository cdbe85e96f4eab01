"""One training step: the port's group step and AdamW against the JAX package.

The same numpy weights (``params_from_jax``) and the same (G, B, T) batch
go through ``genomics_lm_tpu.training.train_step.make_train_step`` and the
port's step on the CPU, float32, dropout 0. The JAX step runs with a
transformation that keeps the averaged group gradient as its state and
applies no update, so both sides' gradients can be compared leaf for leaf
(through ``state_dict_from_jax``); they and the loss metrics must agree to
1e-5 relative. ``build_optimizer`` fed the same gradients must track
optax's AdamW to 1e-6 over three cosine-scheduled steps in both groups,
and the warmup, cosine and plateau schedules must follow JAX's.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.training import optim as jax_optim
from genomics_lm_tpu.training import train_step as jax_step
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.training import optim
from genomics_lm_torch.training.train_step import (
    LossConfig,
    composite_loss,
    make_eval_step,
    make_train_step,
)
from genomics_lm_torch.utils.weights import params_from_jax, state_dict_from_jax

RTOL = 1e-5
G, B, T = 3, 2, 64
RUN_CFG = {"lr": 1e-3, "lr_embedding": 2e-3, "min_lr": 1e-4, "weight_decay": 0.05,
           "warmup_steps": 1, "scheduler": "cosine"}


def make_pair(seed=0, **over):
    kw = dict(vocab_size=68, block_size=T, n_layer=2, n_head=4, n_embd=64, dropout=0.0,
              label_smoothing=0.05, sep_id=3)
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu").train()
    return params, jcfg, model, tcfg


def make_batch(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(4, 68, (G, B, T)).astype(np.int32)
    x[..., ::23] = 3
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    y[1, 0, -5:] = 0  # pad targets in one microbatch
    return x, y


def grad_capture():
    """A transformation whose state is the gradient it was given; no update."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def run_jax(params, jcfg, x, y):
    tx = grad_capture()
    step = jax_step.make_train_step(jcfg, jax_step.LossConfig(), tx)
    new_params, grads, metrics = step(params, tx.init(params),
                                      {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                                      jax.random.PRNGKey(0), jnp.float32(1.0))
    return new_params, grads, metrics


def run_torch(model, tcfg, x, y):
    bundle = optim.build_optimizer(dict(RUN_CFG, lr=0.0, lr_embedding=0.0), model, 10)
    step = make_train_step(tcfg, LossConfig())
    batch = {"x": torch.from_numpy(x).long(), "y": torch.from_numpy(y).long()}
    return step(model, bundle, batch, None, 1.0)


def assert_rel(got, want, rtol=RTOL, what="", floor=1e-12):
    """max |got - want| within ``rtol`` of the larger of max |want| and ``floor``."""
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(np.asarray(got, dtype=np.float64) - want).max()) / scale
    assert err <= rtol, f"{what}: {err} > {rtol}"


@pytest.mark.parametrize("fused_qkv", [False, True], ids=["qkv", "fused_qkv"])
def test_group_gradients_and_metrics_match_jax(fused_qkv):
    params, jcfg, model, tcfg = make_pair(fused_qkv=fused_qkv)
    x, y = make_batch()
    _, jgrads, jmetrics = run_jax(params, jcfg, x, y)
    metrics = run_torch(model, tcfg, x, y)
    assert bool(metrics["applied"]) and bool(jmetrics["applied"])
    for key in ("finite_microbatches", "nonpad_tokens", "committed_microbatches",
                "discarded_before_nonfinite"):
        assert int(metrics[key]) == int(jmetrics[key]), key
    assert int(metrics["nonpad_tokens"]) == int((y != 0).sum())
    for key in ("total_loss_sum", "next_loss_sum", "first_loss"):
        assert_rel(float(metrics[key]), float(jmetrics[key]), what=key)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    # a key bias shifts every score of a row alike, so its gradient is 0 in
    # exact arithmetic and rounding noise here: each tensor is held to the
    # larger of its own max and a thousandth of the model's max
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, g in got.items():
        assert_rel(g.numpy(), want[name].numpy(), what=name, floor=floor)


def test_adamw_groups_track_optax_over_cosine_steps():
    params, _, model, tcfg = make_pair(termination_aux=True, multi_offset_targets=(1,))
    jbundle = jax_optim.build_optimizer(RUN_CFG, params, total_steps=10)
    state = jbundle.tx.init(params)
    bundle = optim.build_optimizer(RUN_CFG, model, total_steps=10)
    assert {g["label"] for g in bundle.optimizer.param_groups} == {"fast", "base"}
    rng = np.random.default_rng(2)
    jparams = params
    for lr_scale in (1.0, 0.5, 1.0):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
                             jparams)
        updates, state = jbundle.tx.update(grads, state, jparams)
        updates = jax.tree.map(lambda u: u * lr_scale, updates)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = state_dict_from_jax(jax.tree.map(np.asarray, grads), tcfg)
        for name, p in model.named_parameters():
            p.grad = tgrads[name]
        bundle.step(lr_scale)
    assert bundle.applied_steps == 3
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("warmup", [{"warmup_steps": 7}, {"warmup_fraction": 0.1},
                                    {"warmup_fraction": 0.0}, {}],
                         ids=["steps", "fraction", "fraction0", "default"])
def test_warmup_and_cosine_multiplier_match_jax(warmup):
    total = 300
    steps = optim.resolve_warmup_steps(warmup, total)
    assert steps == jax_optim.resolve_warmup_steps(warmup, total)
    got = optim.cosine_lr_lambda(steps, total, 0.1)
    want = jax_optim.cosine_lr_lambda(steps, total, 0.1)
    for i in (0, 1, steps - 1, steps, steps + 1, total // 2, total - 1, total + 5):
        np.testing.assert_allclose(got(i), float(want(i)), rtol=1e-6, err_msg=str(i))


def test_plateau_schedule_matches_jax():
    """Plateau mode: no multiplier in the bundle, the host-side scale (warmup,
    then halving after ``patience`` bad epochs) follows JAX's, and the step
    runs each group at its base lr times ``lr_scale``."""
    params, _, model, _ = make_pair()
    cfg = dict(RUN_CFG, scheduler="plateau", plateau_patience=1, warmup_steps=3)
    bundle = optim.build_optimizer(cfg, model, total_steps=10)
    jbundle = jax_optim.build_optimizer(cfg, params, total_steps=10)
    assert bundle.schedule_name == jbundle.schedule_name == "plateau"
    assert bundle.lr_lambda is None
    for step, metric in enumerate((3.0, 2.0, 2.5, 2.6, 2.7, 2.8, 1.0, 1.5, 1.6, 1.7)):
        assert bundle.plateau.scale(step) == jbundle.plateau.scale(step), step
        bundle.plateau.step_metric(metric)
        jbundle.plateau.step_metric(metric)
    assert bundle.plateau.state_dict() == jbundle.plateau.state_dict()
    assert bundle.plateau.current_scale == 0.125
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    bundle.step(bundle.plateau.scale(10))
    assert {g["label"]: g["lr"] for g in bundle.optimizer.param_groups} == {
        "base": RUN_CFG["lr"] * 0.125}


def test_nonfinite_microbatch_aborts_the_group_on_both_sides():
    """A tok_emb row of inf for a token only microbatch 1 of 3 holds. The
    head is untied, so the other microbatches stay finite."""
    params, jcfg, model, tcfg = make_pair(tie_embeddings=False)
    for p in model.parameters():  # a previous group's gradient is not kept
        p.grad = torch.ones_like(p)
    x, y = make_batch(seed=3)
    x[x == 67] = 66
    x[1, 0, 5] = 67
    params = dict(params, tok_emb=params["tok_emb"].at[67].set(jnp.inf))
    with torch.no_grad():
        model.tok_emb.weight[67] = float("inf")
    before = copy.deepcopy(model.state_dict())
    jparams, _, jmetrics = run_jax(params, jcfg, x, y)
    metrics = run_torch(model, tcfg, x, y)
    assert not bool(jmetrics["applied"]) and not bool(metrics["applied"])
    for key in ("discarded_before_nonfinite", "finite_microbatches",
                "committed_microbatches", "nonpad_tokens"):
        assert int(metrics[key]) == int(jmetrics[key]), key
    assert int(metrics["discarded_before_nonfinite"]) == 1
    assert int(metrics["finite_microbatches"]) == 2
    assert float(metrics["total_loss_sum"]) == float(jmetrics["total_loss_sum"]) == 0.0
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, before[name], rtol=0, atol=0, equal_nan=True)
    assert all(p.grad is None for p in model.parameters())


def test_param_group_labels_match_jax_key_for_key():
    """Each leaf of the JAX tree is tagged with its index; the loader carries
    the tags into the torch keys (fused QKV concatenates three), so every
    torch parameter is held to the labels of the leaves it came from."""
    over = dict(termination_aux=True, multi_offset_targets=(1, 2), fused_qkv=True,
                tie_embeddings=False)
    params, _, model, tcfg = make_pair(**over)
    leaves, treedef = jax.tree.flatten(params)
    tagged = jax.tree.unflatten(treedef, [np.full(np.shape(a), i, np.float32)
                                          for i, a in enumerate(leaves)])
    jlabels = jax.tree.leaves(jax_optim.param_group_labels(params))
    labels = optim.param_group_labels(model)
    sources = state_dict_from_jax(tagged, tcfg)
    assert set(labels) == set(sources)
    for name, tag in sources.items():
        assert {jlabels[int(i)] for i in torch.unique(tag)} == {labels[name]}, name
    assert {"fast", "base"} == set(labels.values())


def test_eval_step_matches_jax():
    params, jcfg, model, tcfg = make_pair(seed=4)
    x, y = make_batch(seed=5)
    want = jax_step.make_eval_step(jcfg, jax_step.LossConfig())(
        params, jnp.asarray(x[0]), jnp.asarray(y[0]))
    got = make_eval_step(tcfg, LossConfig())(model, torch.from_numpy(x[0]).long(),
                                            torch.from_numpy(y[0]).long())
    assert set(got) == set(want)
    assert int(got["nonpad_tokens"]) == int(want["nonpad_tokens"])
    for key in ("total_loss", "next_loss", "next_loss_token_sum"):
        assert_rel(float(got[key]), float(want[key]), what=key)


def test_unported_options_raise():
    _, _, model, tcfg = make_pair()
    x = torch.zeros((2, 8), dtype=torch.long)
    for loss_cfg in (LossConfig(multi_offset_weights=((1, 0.5),)),
                     LossConfig(termination_enabled=True), LossConfig(replay_enabled=True)):
        with pytest.raises(NotImplementedError):
            make_train_step(tcfg, loss_cfg)
        with pytest.raises(NotImplementedError):
            composite_loss(model, tcfg, loss_cfg, x, x, train=False, generator=None)
    with pytest.raises(NotImplementedError):
        make_train_step(tcfg.replace(use_checkpoint=True), LossConfig())
    for extra in ({"optimizer": "adafactor"}, {"freeze_backbone": True}, {"lora_rank": 8},
                  {"grad_clip": 1.0}):
        with pytest.raises(NotImplementedError):
            optim.build_optimizer(dict(RUN_CFG, **extra), model, 10)
