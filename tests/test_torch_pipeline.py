"""GPipe pipeline parallelism of the port against the JAX package, on the CPU.

The ranks run through ``genomics_lm_torch.parallel.launch.spawn`` (gloo over
a ``file://`` store; each child runs the torch-only ``parallel/workers.py``
and imports no JAX). JAX's references run here, float32, dropout 0:

- ``split_stage_params`` / ``merge_stage_params``: each stage's parameters
  are the stage's slice of JAX's stage-split tree, and merging restores the
  full state, at 1, 2 and 4 stages.
- One group step (3 microbatches of ragged non-pad counts) at PP 2 (M > S),
  PP 2 x DP 2 and PP 2 x DP 2 x TP 2 (8 ranks) against JAX's one-device
  whole-group CE and its ``value_and_grad`` (``codon_gpt.forward`` and
  ``cross_entropy_parts``), within 1e-5; the group step's metrics against
  JAX's ``make_pipeline_group_step`` on a pipe mesh, and not the mean of the
  microbatch means.
- The eval step pads its rows to the pipeline quantum exactly: the loss,
  non-pad count and token sum of the plain forward on the real rows.

The trainer's pipeline branch is in ``tests/test_torch_pipeline_trainer.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.ops.losses import cross_entropy_parts
from genomics_lm_tpu.parallel import mesh as jax_mesh
from genomics_lm_tpu.parallel import pipeline as jax_pp
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.parallel import launch, workers
from genomics_lm_torch.parallel import pipeline as port_pp
from genomics_lm_torch.training.loop import GROUP_METRIC_KEYS
from genomics_lm_torch.utils.weights import params_from_jax, state_dict_from_jax

RTOL = 1e-5
G, B, T = 3, 4, 16
MODEL = dict(vocab_size=68, block_size=T, n_layer=4, n_head=4, n_embd=32, dropout=0.0,
             label_smoothing=0.05, sep_id=3, fused_qkv=True)
RUN = {"lr": 1e-3, "min_lr": 1e-4, "warmup_steps": 1, "shard_optimizer_state": True}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel_err(got, want, floor=1e-12) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), floor)


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_split_and_merge_are_jax_stage_slices(stages):
    jcfg = JaxConfig(**MODEL)
    params = jax_gpt.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    full = state_dict_from_jax(tree, CodonGPTConfig(**MODEL))
    staged = jax.tree.map(np.asarray, jax_pp.split_stage_params(params, stages))
    per = MODEL["n_layer"] // stages
    parts = []
    for s in range(stages):
        mine = port_pp.split_stage_params(full, MODEL["n_layer"], stages, s)
        stage_tree = dict(staged, blocks=jax.tree.map(lambda a: a[s], staged["blocks"]))
        want = state_dict_from_jax(stage_tree, CodonGPTConfig(**dict(MODEL, n_layer=per)))
        assert set(mine) == set(want)
        for name, value in want.items():
            assert torch.equal(mine[name], value), (s, name)
        parts.append(mine)
    merged = port_pp.merge_stage_params(parts, per)
    assert set(merged) == set(full)
    assert all(torch.equal(merged[n], v) for n, v in full.items())
    with pytest.raises(ValueError, match="not divisible by n_stages=3"):
        port_pp.split_stage_params(full, MODEL["n_layer"], 3, 0)


# --- the group step ----------------------------------------------------------------

def ragged_group():
    rng = np.random.default_rng(21)
    x = rng.integers(4, 68, (G, B, T)).astype(np.int32)
    x[..., ::5] = 3
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    for g in range(G):  # microbatch g keeps the first 3 + 5g targets of most rows
        y[g, :-1, 3 + 5 * g:] = 0
    return x, y


EVAL_ROWS = 5  # pads to the pipeline quantum: 3 microbatches of 2 rows at PP 2
STEP_CASES = {"pp2": (2, {"data": 1, "pipe": 2}), "pp2_dp2": (4, {"data": 2, "pipe": 2}),
              "pp2_dp2_tp2": (8, {"data": 2, "model": 2, "pipe": 2})}


@pytest.fixture(scope="module")
def step_runs():
    jcfg = JaxConfig(**MODEL)
    params = jax_gpt.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    x, y = ragged_group()
    rng = np.random.default_rng(5)
    xe = rng.integers(4, 68, (EVAL_ROWS, T)).astype(np.int32)
    ye = np.roll(xe, -1, axis=-1)
    ye[1, 4:] = 0

    def ce_parts(p, xb, yb):
        logits, _ = jax_gpt.forward(p, jcfg, xb)
        return cross_entropy_parts(logits, yb, ignore_index=0,
                                   label_smoothing=MODEL["label_smoothing"])

    def group_loss(p):
        parts = [ce_parts(p, jnp.asarray(x[g]), jnp.asarray(y[g])) for g in range(G)]
        return sum(n for n, _ in parts) / sum(d for _, d in parts), parts

    (jloss, parts), jgrads = jax.jit(jax.value_and_grad(group_loss, has_aux=True))(params)
    per_mb = [float(n / d) for n, d in parts]
    # JAX's own pipeline group step on a pipe mesh of 2, for its metrics
    mesh = jax_mesh.make_mesh(2, axes={"pipe": 2})
    staged = jax_pp.split_stage_params(params, 2)
    staged = jax.device_put(staged, jax_pp.stage_param_sharding(mesh, staged))
    tx = optax.adamw(1e-3)
    opt = jax.device_put(jax_pp.split_stage_params(tx.init(params), 2),
                         jax_pp.stage_opt_state_sharding(mesh, jax_pp.split_stage_params(
                             tx.init(params), 2)))
    _, _, jmetrics = jax_pp.make_pipeline_group_step(jcfg, tx, mesh)(
        staged, opt, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jax.random.PRNGKey(0),
        jnp.float32(1.0))
    n, d = jax.jit(ce_parts)(params, jnp.asarray(xe), jnp.asarray(ye))
    spec = {"model": MODEL, "tree": tree, "groups": [(x, y)], "run_cfg": RUN,
            "total_steps": 10, "return_grads": True}
    ranks = {}
    for case, (world, axes) in STEP_CASES.items():
        evals = dict(spec, axes=axes, groups=[], eval=[(xe, ye)], return_grads=False,
                     return_tree=False)
        out = launch.spawn(workers.group_steps, world, [dict(spec, axes=axes), evals], device="cpu")
        ranks[case] = [r[0] for r in out], [r[1]["eval"][0] for r in out]
    return {"loss": float(jloss),
            "grads": state_dict_from_jax(jax.tree.map(np.asarray, jgrads),
                                         CodonGPTConfig(**MODEL)),
            "mean_of_means": float(np.mean(per_mb)), "nonpad": int((y != 0).sum()),
            "jax_metrics": {k: float(v) for k, v in jmetrics.items()},
            "eval": {"loss": float(n / d), "nonpad": int((ye != 0).sum())},
            "ranks": ranks}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_group_step_is_jax_whole_group_ce_and_its_gradient(step_runs, case):
    ranks, _ = step_runs["ranks"][case]
    for r in ranks:
        m = r["metrics"][0]
        assert m["applied"] == 1.0 and m["nonpad_tokens"] == step_runs["nonpad"]
        assert rel_err(m["first_loss"], step_runs["loss"]) <= RTOL
        assert rel_err(m["total_loss_sum"], G * step_runs["loss"]) <= RTOL
    want = step_runs["grads"]
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    got = ranks[0]["grads"]
    assert set(got) == set(want)
    for name, g in got.items():
        assert rel_err(g.numpy(), want[name].numpy(), floor) <= RTOL, name


def test_group_step_metrics_are_jax_pipeline_group_steps(step_runs):
    """At a ragged group the metrics are ``make_pipeline_group_step``'s:
    the whole-group CE, not the mean of the microbatch means."""
    jm = step_runs["jax_metrics"]
    got = step_runs["ranks"]["pp2"][0][0]["metrics"][0]
    for key in GROUP_METRIC_KEYS:
        assert rel_err(got[key], jm[key], 1e-9) <= RTOL, (key, got[key], jm[key])
    assert got["discarded_before_nonfinite"] == 0 and got["committed_microbatches"] == G
    assert abs(got["first_loss"] - step_runs["mean_of_means"]) > 1e-4


@pytest.mark.parametrize("case", ["pp2", "pp2_dp2"])
def test_eval_step_pads_rows_exactly(step_runs, case):
    for out in step_runs["ranks"][case][1]:
        assert rel_err(out["next_loss"], step_runs["eval"]["loss"]) <= RTOL
        assert out["total_loss"] == out["next_loss"]
        assert out["nonpad_tokens"] == step_runs["eval"]["nonpad"]
        assert rel_err(out["next_loss_token_sum"],
                       step_runs["eval"]["loss"] * step_runs["eval"]["nonpad"]) <= RTOL


def test_stage_holds_only_its_blocks():
    model = params_from_jax(jax.tree.map(np.asarray, jax_gpt.init(
        jax.random.PRNGKey(0), JaxConfig(**MODEL))), CodonGPTConfig(**MODEL), "cpu")
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    pp = port_pp.PPContext(None, 1, 2, 0, None, "gloo", 2, 2)
    port_pp.stage_model(model, pp)
    got = {n: p for n, p in model.named_parameters()}
    want = port_pp.split_stage_params(full, 4, 2, 1)
    assert set(got) == set(want) and len(model.blocks) == 2
    assert all(torch.equal(got[n], v) for n, v in want.items())
