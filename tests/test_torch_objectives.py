"""The auxiliary objectives and shape guidance: the port against the JAX package.

On the CPU, float32, the same seeded numpy inputs through both packages:

- the multi-offset, termination and replay label and loss functions
  (``ops/losses.py``), with pads, boundaries, stop ids, class weights and
  label smoothing, to ``LOSS_RTOL`` (the same float32 reductions; only
  their order differs), bucket labels and masks exactly;
- ``composite_loss`` with every objective on (two offset heads, the
  termination loss, a replay batch, shape guidance through the encoder),
  dropout 0: total, parts and the gradient of every leaf to ``STEP_RTOL``;
  and one group step with the replay loss on flagged microbatches, its
  metrics and the averaged gradient to ``STEP_RTOL``;
- the shape encoder's ``encode`` to ``LOSS_RTOL`` and ``shape_lookup_table``
  exactly; replay batches for the same seed exactly;
- the replay forward with dropout: JAX reuses the microbatch's key, the
  port draws from its generator, so the two are compared by distribution:
  the mean replay loss over many draws agrees within 5 standard errors.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genomics_lm_tpu.data.replay import GeneratedTerminationReplayDataset as JaxReplay
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import biophysics as jbio
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.ops import losses as jL
from genomics_lm_tpu.training import train_step as jax_step
from genomics_lm_torch.data.replay import GeneratedTerminationReplayDataset
from genomics_lm_torch.models import biophysics
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops import losses as L
from genomics_lm_torch.tokenizers.codon import STOP_IDS
from genomics_lm_torch.training.train_step import (
    LossConfig,
    composite_loss,
    make_eval_step,
    make_train_step,
    replay_loss,
)
from genomics_lm_torch.utils.weights import jax_leaves, params_from_jax

LOSS_RTOL = 1e-6
STEP_RTOL = 1e-5
T = 48


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_rel(got, want, rtol, what="", floor=1e-12):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, floor)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale if want.size else 0.0
    assert err <= rtol, f"{what}: {err} > {rtol}"


def token_batch(seed, shape=(3, T)):
    """Codons with stops, <EOS>/<SEP> boundaries and pad tails."""
    rng = np.random.default_rng(seed)
    y = rng.integers(4, 68, shape)
    y[rng.random(shape) < 0.08] = STOP_IDS[0]
    y[rng.random(shape) < 0.05] = 3
    y[rng.random(shape) < 0.03] = 2
    y[0, -7:] = 0
    y[-1, -2:] = 0
    return y


# --- the loss functions ----------------------------------------------------------


@pytest.mark.parametrize("offset", [1, 2, 4, T, T + 1])
def test_offset_target_mask_matches_jax(offset):
    y = token_batch(0)
    got = L.offset_target_mask(torch.from_numpy(y), offset).numpy()
    want = np.asarray(jL.offset_target_mask(jnp.asarray(y), offset))
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("heads", ["shared", "per_offset"])
@pytest.mark.parametrize("smoothing, weighted", [(0.0, False), (0.1, True)])
def test_multi_offset_loss_matches_jax(heads, smoothing, weighted):
    rng = np.random.default_rng(1)
    y = token_batch(2)
    weights = {1: 0.5, 2: 0.7, 3: 0.0, 5: 1.3, T + 2: 1.0}
    if heads == "shared":
        logits = rng.standard_normal((3, T, 68)).astype(np.float32)
        tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
    else:
        logits = {o: rng.standard_normal((3, T, 68)).astype(np.float32) for o in (2, 5)}
        tl = {o: torch.from_numpy(v) for o, v in logits.items()}
        jl = {o: jnp.asarray(v) for o, v in logits.items()}
    lw = (0.5 + rng.random(68)).astype(np.float32) if weighted else None
    total, parts = L.multi_offset_lm_loss(
        tl, torch.from_numpy(y), weights, label_smoothing=smoothing,
        loss_weights=None if lw is None else torch.from_numpy(lw))
    jtotal, jparts = jL.multi_offset_lm_loss(
        jl, jnp.asarray(y), weights, label_smoothing=smoothing,
        loss_weights=None if lw is None else jnp.asarray(lw))
    assert sorted(parts) == sorted(jparts)
    assert_rel(float(total), float(jtotal), LOSS_RTOL, "total")
    for o in parts:
        assert_rel(float(parts[o]), float(jparts[o]), LOSS_RTOL, f"offset {o}")


@pytest.mark.parametrize("edges", [(0, 3, 10, 30), (1, 2)])
def test_termination_labels_and_loss_match_jax(edges):
    y = token_batch(3)
    y[1, :] = 5  # a row with no stop at all
    got = L.termination_distance_bucket_labels(torch.from_numpy(y), STOP_IDS, edges).numpy()
    want = np.asarray(jL.termination_distance_bucket_labels(jnp.asarray(y), STOP_IDS, edges))
    assert np.array_equal(got, want)
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, T, len(edges) + 1)).astype(np.float32)
    for cw in (None, (0.5 + rng.random(len(edges) + 1)).astype(np.float32)):
        tl = L.termination_aux_loss(torch.from_numpy(logits), torch.from_numpy(got),
                                    None if cw is None else torch.from_numpy(cw))
        jl = jL.termination_aux_loss(jnp.asarray(logits), jnp.asarray(want),
                                     None if cw is None else jnp.asarray(cw))
        assert_rel(float(tl), float(jl), LOSS_RTOL, "termination loss")
    with pytest.raises(ValueError):
        L.termination_distance_bucket_labels(torch.from_numpy(y), (), edges)


# --- shape guidance and replay data -------------------------------------------


def test_shape_encoder_and_lookup_match_jax():
    assert np.array_equal(biophysics.shape_lookup_table(), jbio.shape_lookup_table())
    enc = jax.tree.map(np.asarray, jbio.init_encoder(jax.random.PRNGKey(0)))
    enc["conv1"]["b"] = np.linspace(-0.2, 0.2, 32).astype(np.float32)
    enc["conv2"]["b"] = np.array([0.1, -0.3, 0.05], np.float32)
    rng = np.random.default_rng(5)
    one_hot = jbio.shape_lookup_table()[rng.integers(0, 68, (2, 20))].reshape(2, 60, 4)
    want = np.asarray(jbio.encode(jax.tree.map(jnp.asarray, enc), jnp.asarray(one_hot)))
    model = params_from_jax(
        dict(jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(1), small_jcfg())),
             shape_encoder=enc), small_tcfg(), "cpu")
    got = biophysics.encode(model.shape_encoder, torch.from_numpy(one_hot)).detach().numpy()
    assert got.shape == want.shape == (2, 20, 3)
    assert_rel(got, want, LOSS_RTOL, "encode")
    seq = "".join(np.random.default_rng(6).choice(list("ACGTN"), 31))
    assert biophysics.get_theoretical_shape(seq) == jbio.get_theoretical_shape(seq)
    assert np.array_equal(biophysics.one_hot_dna(seq), jbio.one_hot_dna(seq))
    X, Y = biophysics.generate_shape_training_data(4, 5, seed=3)
    jX, jY = jbio.generate_shape_training_data(4, 5, seed=3)
    assert np.array_equal(X, jX) and np.array_equal(Y, jY)


def write_replay(path, n=10, seed=7, length=30):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        ids = [int(t) for t in rng.integers(4, 68, length + (i % 3) * 9)]
        rec = ({"ids": ids, "labels": [{"pos": int(p), "class": int(p) % 5}
                                       for p in rng.integers(0, len(ids), 2)]}
               if i % 2 else {"ids": ids, "label_position": len(ids) - 2, "target_class": 3})
        lines.append(json.dumps(rec))
    lines += ["", json.dumps({"ids": [5, 6]}), json.dumps({"ids": [5], "labels": [{"pos": 9,
                                                                                   "class": 1}]})]
    path.write_text("\n".join(lines) + "\n")
    return path


def test_replay_batches_match_jax(tmp_path):
    path = write_replay(tmp_path / "replay.jsonl")
    ours, theirs = GeneratedTerminationReplayDataset(path, 32), JaxReplay(path, 32)
    assert np.array_equal(ours.x, theirs.x) and np.array_equal(ours.y, theirs.y)
    a, b = ours.batches(3, seed=11), theirs.batches(3, seed=11)
    for _ in range(7):
        (x1, y1), (x2, y2) = next(a), next(b)
        assert np.array_equal(x1, x2) and np.array_equal(y1, y2)


# --- the composite loss and the step -------------------------------------------


def small_kw(**over):
    kw = dict(vocab_size=68, block_size=T, n_layer=2, n_head=4, n_embd=64, dropout=0.0,
              label_smoothing=0.05, sep_id=3, termination_aux=True,
              multi_offset_targets=(2, 3), use_shape_guidance=True)
    kw.update(over)
    return kw


def small_jcfg(**over):
    return JaxConfig(**small_kw(**over))


def small_tcfg(**over):
    return CodonGPTConfig(**small_kw(**over))


LOSS_CFG = dict(multi_offset_weights=((2, 0.3), (3, 0.2)), label_smoothing=0.05,
                termination_enabled=True, termination_weight=0.7,
                termination_stop_ids=STOP_IDS, termination_class_weights=(1.0, 2.0, 1.0,
                                                                           0.5, 1.5),
                replay_enabled=True, replay_weight=0.4,
                replay_class_weights=(0.5, 1.0, 1.0, 2.0, 1.0))


def all_objective_params(seed=0):
    """A JAX tree with every objective's leaves, the shape projection and
    the offset heads moved off their no-op init so every path carries
    gradient."""
    params = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(seed), small_jcfg()))
    rng = np.random.default_rng(seed)
    params["shape_proj"]["w"] = (0.3 * rng.standard_normal((3, 64))).astype(np.float32)
    for o in ("2", "3"):
        params["offset_projs"][o]["fc"]["w"] = (
            params["offset_projs"][o]["fc"]["w"]
            + 0.05 * rng.standard_normal((64, 64))).astype(np.float32)
    params["shape_encoder"] = jax.tree.map(np.asarray, jbio.init_encoder(
        jax.random.PRNGKey(seed + 1)))
    return params


def replay_batch(seed=8, n=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(4, 68, (n, T))
    labels = np.full((n, T), -100)
    labels[:, 5] = rng.integers(0, 5, n)
    labels[:, 30] = rng.integers(0, 5, n)
    return x, labels


def grad_floor(grads: dict) -> float:
    """A key bias shifts every score of a row alike, so its gradient is 0
    in exact arithmetic and rounding noise here: each leaf is held to the
    larger of its own max and a thousandth of the model's max."""
    return 1e-3 * max(float(np.abs(g).max()) for g in grads.values())


def grads_by_leaf(model, tcfg):
    return {leaf.path: leaf.gather(lambda p: p.grad).numpy()
            for leaf in jax_leaves(model, tcfg) if leaf.parts[0][0].grad is not None}


def test_composite_loss_with_every_objective_matches_jax():
    params = all_objective_params()
    y = token_batch(9, (2, T))
    x = np.roll(y, 1, axis=1)
    x[:, 0] = 1
    rx, rl = replay_batch()
    table = jbio.shape_lookup_table()
    jcfg, tcfg = small_jcfg(), small_tcfg()

    def jloss(p):
        return jax_step.composite_loss(
            p, jcfg, jax_step.LossConfig(**LOSS_CFG), jnp.asarray(x), jnp.asarray(y),
            train=False, rng=None, replay=(jnp.asarray(rx), jnp.asarray(rl)),
            shape_lookup=jnp.asarray(table))

    (jtotal, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = params_from_jax(params, tcfg, "cpu").train()
    total, parts = composite_loss(
        model, tcfg, LossConfig(**LOSS_CFG), torch.from_numpy(x), torch.from_numpy(y),
        train=False, generator=None, replay=(torch.from_numpy(rx), torch.from_numpy(rl)),
        shape_lookup=torch.from_numpy(table))
    total.backward()
    total = total.detach()
    assert_rel(float(total), float(jtotal), STEP_RTOL, "total")
    for key in ("next_loss", "term_loss", "replay_loss"):
        assert_rel(float(parts[key].detach()), float(jparts[key]), STEP_RTOL, key)
    for o in (2, 3):
        assert_rel(float(parts["offset_losses"][o].detach()), float(jparts["offset_losses"][o]),
                   STEP_RTOL, f"offset {o}")
    flat = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    got = grads_by_leaf(model, tcfg)
    assert set(got) == set(flat)
    for path, g in flat.items():
        assert_rel(got[path], g, STEP_RTOL, f"grad {path}", floor=grad_floor(flat))
    # every objective's path carries gradient, the encoder included
    assert np.abs(got["shape_encoder/conv1/w"]).max() > 0
    assert np.abs(got["termination_head/w"]).max() > 0

    # the eval step reports the same parts
    out = make_eval_step(tcfg, LossConfig(**LOSS_CFG), shape_lookup=torch.from_numpy(table))(
        model, torch.from_numpy(x), torch.from_numpy(y))
    jout = jax_step.make_eval_step(jcfg, jax_step.LossConfig(**LOSS_CFG),
                                   shape_lookup=jnp.asarray(table))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y))
    assert sorted(out) == sorted(jout)
    for key in out:
        assert_rel(float(out[key]), float(jout[key]), STEP_RTOL, f"eval {key}")


def grad_capture():
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_group_step_with_replay_matches_jax():
    from genomics_lm_torch.training import optim

    params = all_objective_params(3)
    G = 3
    y = np.stack([token_batch(20 + g, (2, T)) for g in range(G)])
    x = np.roll(y, 1, axis=-1)
    rx, rl = replay_batch(4)
    mask = np.array([False, True, True])
    table = jbio.shape_lookup_table()
    jcfg, tcfg = small_jcfg(), small_tcfg()
    tx = grad_capture()
    jparams = jax.tree.map(jnp.asarray, params)
    jstep = jax_step.make_train_step(jcfg, jax_step.LossConfig(**LOSS_CFG), tx,
                                     use_replay=True, shape_lookup=jnp.asarray(table))
    _, jgrads, jm = jstep(jparams, tx.init(jparams),
                          {"x": jnp.asarray(x), "y": jnp.asarray(y),
                           "replay_x": jnp.asarray(rx), "replay_labels": jnp.asarray(rl),
                           "replay_mask": jnp.asarray(mask)},
                          jax.random.PRNGKey(0), jnp.float32(1.0))
    model = params_from_jax(params, tcfg, "cpu").train()
    bundle = optim.build_optimizer({"lr": 0.0, "lr_embedding": 0.0, "warmup_steps": 0,
                                    "unfreeze_encoder": True}, model, 10)
    step = make_train_step(tcfg, LossConfig(**LOSS_CFG), use_replay=True,
                           shape_lookup=torch.from_numpy(table))
    m = step(model, bundle, {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                             "replay_x": torch.from_numpy(rx),
                             "replay_labels": torch.from_numpy(rl),
                             "replay_mask": mask.tolist()}, None, 1.0)
    assert bool(m["applied"]) and bool(jm["applied"])
    assert int(m["replay_count"]) == int(jm["replay_count"]) == 2
    for key in ("total_loss_sum", "next_loss_sum", "term_loss_sum", "replay_loss_sum",
                "offset_2_sum", "offset_3_sum", "first_loss"):
        assert_rel(float(m[key]), float(jm[key]), STEP_RTOL, key)
    flat = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for path, g in grads_by_leaf(model, tcfg).items():
        assert_rel(g, flat[path], STEP_RTOL, f"grad {path}", floor=grad_floor(flat))


def test_replay_forward_with_dropout_matches_jax_in_distribution():
    """Mean and spread of the replay loss over 200 dropout draws (rate 0.3):
    the JAX forward from 200 keys, the port's from one generator's stream."""
    kw = dict(dropout=0.3, multi_offset_targets=(), use_shape_guidance=False)
    params = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(2), small_jcfg(**kw)))
    jcfg, tcfg = small_jcfg(**kw), small_tcfg(**kw)
    rx, rl = replay_batch(5, n=4)
    loss_cfg = dict(replay_enabled=True, replay_class_weights=None)

    @jax.jit
    def jreplay(p, key):
        _, _, aux = jax_gpt.forward(p, jcfg, jnp.asarray(rx), None, train=True, rng=key,
                                    return_aux=True)
        return jL.termination_aux_loss(aux["termination_logits"], jnp.asarray(rl))

    jp = jax.tree.map(jnp.asarray, params)
    n = 200
    want = np.array([float(jreplay(jp, k)) for k in jax.random.split(jax.random.PRNGKey(9), n)])
    model = params_from_jax(params, tcfg, "cpu").train()
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        got = np.array([float(replay_loss(model, tcfg, LossConfig(**loss_cfg),
                                          (torch.from_numpy(rx), torch.from_numpy(rl)),
                                          train=True, generator=gen)) for _ in range(n)])
    with torch.no_grad():
        plain = float(replay_loss(model, tcfg, LossConfig(**loss_cfg),
                                  (torch.from_numpy(rx), torch.from_numpy(rl)), train=False,
                                  generator=None))
    assert np.std(got) > 0 and not np.allclose(got, plain)  # dropout acted
    se = np.sqrt(np.var(got) / n + np.var(want) / n)
    assert abs(got.mean() - want.mean()) < 5 * se, (got.mean(), want.mean(), se)
    assert 0.7 < np.std(got) / np.std(want) < 1.4


def test_replay_module_is_the_jax_copy():
    import inspect

    from genomics_lm_tpu.data import replay as jreplay
    from genomics_lm_torch.data import replay

    want, got = inspect.getsource(jreplay), inspect.getsource(replay)
    assert got[got.index("from __future__"):] == want[want.index("from __future__"):]
