"""Expert parallelism and MoE under a data mesh, the port against JAX's one device.

Every multi-rank check spawns its ranks through
``genomics_lm_torch.parallel.launch.spawn`` (gloo over a ``file://`` store;
each child runs the torch-only ``parallel/workers.py`` and imports no JAX).
Float32, dropout 0, capacity factor 0.5 (about half the choices drop, so
the capacity and the slot order decide the result), within 1e-5:

- Each leaf's model-axis spec is JAX's ``moe_param_sharding``'s (experts
  split when the axis divides E, else replicated; attention Megatron), and
  each rank's slice of a port parameter is that spec's slice of the leaf.
- ``_moe_mlp`` on each of 2 expert-parallel ranks: the ranks' partial
  outputs sum to JAX's, and the gradients of their losses (the router
  loss whole on each rank, 1/ep of its gradient) sum to JAX's: input,
  router and each rank's experts.
- EP 2, DP 2 with an odd B (one padding row) and DP 2 x EP 2 group steps
  against JAX's one-device step: metrics and every gradient. Beside them,
  routing each rank's rows on their own (a per-rank capacity) misses JAX's
  loss by more than 1e-3: the fault the global routing guards against.

The trainer CLI and the serving engine under a mesh are in
``tests/test_torch_moe_mesh.py``.
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
from genomics_lm_tpu.parallel import mesh as jax_mesh
from genomics_lm_tpu.parallel import sharding as jax_sharding
from genomics_lm_tpu.training import train_step as jax_step
from genomics_lm_torch.models import codon_gpt as port_gpt
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.parallel import launch, sharding, workers
from genomics_lm_torch.parallel import tensor_parallel as tpl
from genomics_lm_torch.utils.weights import jax_leaves, params_from_jax, state_dict_from_jax

RTOL = 1e-5
G, B, T = 2, 5, 16
MODEL = dict(vocab_size=68, block_size=T, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
             moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5, moe_aux_weight=0.01)
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


def jax_tree(**over):
    params = jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**dict(MODEL, **over)))
    return params, jax.tree.map(np.asarray, params)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, prefix + (str(k),)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


# --- the rules ------------------------------------------------------------------

RULE_CASES = {"e4_model2": (4, 2, {}), "e4_model4": (4, 4, {}),
              "e4_model2_swiglu": (4, 2, {"use_swiglu": True}),
              "e3_model2_replicated": (3, 2, {})}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_expert_rules_match_moe_param_sharding(case):
    E, tp, over = RULE_CASES[case]
    _, tree = jax_tree(moe_experts=E, **over)
    tcfg = CodonGPTConfig(**dict(MODEL, moe_experts=E, **over))
    jmesh = jax_mesh.make_mesh(8, axes={"data": 8 // tp, "model": tp})
    want = flat(jax_sharding.moe_param_sharding(tree, jmesh, n_experts=E, axis="model",
                                                tp_axis="model"))
    leaves = flat(tree)
    for path, leaf in leaves.items():
        got = tuple(sharding.model_axis_spec(path, leaf.shape, tp, E))
        expect = tuple(want[path].spec)
        assert got + (None,) * (len(expect) - len(got)) == expect + (None,) * (
            len(got) - len(expect)), path
    full = params_from_jax(tree, tcfg, "cpu")
    names = {id(p): n for n, p in full.named_parameters()}
    for r in range(tp):
        local = tpl.shard_model(full, tpl.TPContext(None, r, tp), copy_model=True)
        lp = dict(local.named_parameters())
        split_experts = E % tp == 0
        assert (getattr(local.blocks[0].mlp, "experts", None)
                == ((r * E // tp, E // tp) if split_experts else None))
        for leaf in jax_leaves(full, tcfg):
            path = tuple(leaf.path.split("/"))
            value = leaves[path]
            spec = tuple(want[path].spec)
            if "model" in spec:
                value = np.split(value, tp, axis=spec.index("model"))[r]
            for i, (p, rows, t) in enumerate(leaf.parts):
                part = value[i] if leaf.stacked else value
                part = part.T if t else part
                got = lp[names[id(p)]].detach().numpy()
                if rows is not None:  # a fused QKV block: not in this config
                    raise AssertionError(path)
                np.testing.assert_array_equal(got, part, err_msg=f"{leaf.path} rank {r}")


# --- the layer ------------------------------------------------------------------

@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu", "swiglu"])
def test_moe_mlp_partials_of_two_expert_ranks_sum_to_jax(swiglu):
    """Two expert-parallel ranks of one layer, in one process: their
    float32 partial outputs sum to JAX's ``_moe_mlp`` output, each holds
    JAX's router loss, and the gradients of their losses sum to JAX's."""
    params, tree = jax_tree(use_swiglu=swiglu)
    jcfg = JaxConfig(**dict(MODEL, use_swiglu=swiglu))
    tcfg = CodonGPTConfig(**dict(MODEL, use_swiglu=swiglu))
    rng = np.random.default_rng(3)
    h = rng.standard_normal((3, T, 32)).astype(np.float32)
    dy = rng.standard_normal((3, T, 32)).astype(np.float32)
    w = 0.37  # the router loss's weight, large enough to matter
    block_p = jax.tree.map(lambda a: a[0], params["blocks"])

    def jax_loss(bp, hh):
        y, aux = jax_gpt._moe_mlp(bp, jcfg, hh, capped=True)
        return jnp.sum(y * dy) + w * aux, (y, aux)

    (_, (jy, jaux)), (jgb, jgh) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(block_p, jnp.asarray(h))
    full = params_from_jax(tree, tcfg, "cpu")
    y_sum, gh, grouter, gexp = 0.0, 0.0, 0.0, {}
    for r in range(2):
        local = tpl.shard_model(full, tpl.TPContext(None, r, 2), copy_model=True)
        block = local.blocks[0]
        hh = torch.from_numpy(h).requires_grad_()
        y, aux = port_gpt._moe_mlp(block, tcfg, hh, capped=True)
        assert y.dtype == torch.float32
        assert abs(float(aux.detach()) - float(jaux)) <= RTOL * abs(float(jaux))
        loss = (y * torch.from_numpy(dy)).sum() + w * aux
        bank = dict(block.mlp.named_parameters())
        grads = torch.autograd.grad(loss, [hh, block.router.w, *bank.values()])
        y_sum = y_sum + y.detach().numpy()
        gh = gh + grads[0].numpy()
        grouter = grouter + grads[1].numpy()
        for name, g in zip(bank, grads[2:]):
            gexp.setdefault(name, []).append(g.numpy())
    assert rel_err(y_sum, jy) <= RTOL
    assert rel_err(gh, jgh) <= RTOL
    assert rel_err(grouter, jgb["router"]["w"]) <= RTOL
    for name, parts in gexp.items():
        bank, leaf = name.split(".")
        assert rel_err(np.concatenate(parts), jgb["mlp"][bank][leaf]) <= RTOL, name


# --- group steps ------------------------------------------------------------------

def capture():
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def step_batch():
    rng = np.random.default_rng(1)
    x = rng.integers(4, 68, (G, B, T)).astype(np.int32)
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    y[0, 1, 5:] = 0
    y[1, 4, 9:] = 0
    return x, y


STEP_CASES = {"ep2": {"data": 1, "model": 2}, "dp2_odd_b": {"data": 2},
              "dp2_ep2": {"data": 2, "model": 2}}


@pytest.fixture(scope="module")
def step_runs():
    params, tree = jax_tree()
    jcfg = JaxConfig(**MODEL)
    x, y = step_batch()
    jstep = jax_step.make_train_step(jcfg, jax_step.LossConfig(), capture())
    _, jgrads, jm = jstep(params, capture().init(params), {"x": jnp.asarray(x),
                                                           "y": jnp.asarray(y)},
                          jax.random.PRNGKey(0), jnp.float32(1.0))
    spec = {"model": MODEL, "tree": tree, "groups": [(x, y)], "run_cfg": RUN,
            "total_steps": 10, "return_grads": True}
    two = launch.spawn(workers.group_steps, 2, [dict(spec, axes=STEP_CASES[c])
                                                for c in ("ep2", "dp2_odd_b")], device="cpu")
    four = launch.spawn(workers.group_steps, 4, dict(spec, axes=STEP_CASES["dp2_ep2"]),
                        device="cpu")
    tcfg = CodonGPTConfig(**MODEL)
    return {"jax_grads": state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg),
            "jax_metrics": {k: float(v) for k, v in jm.items()},
            "ranks": {"ep2": [r[0] for r in two], "dp2_odd_b": [r[1] for r in two],
                      "dp2_ep2": four},
            "tree": tree, "batch": (x, y)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_moe_group_step_matches_jax_single_device(step_runs, case):
    jm = step_runs["jax_metrics"]
    ranks = step_runs["ranks"][case]
    for r in ranks:
        m = r["metrics"][0]
        assert m["applied"] == 1.0 and m["nonpad_tokens"] == jm["nonpad_tokens"]
        for key in ("total_loss_sum", "next_loss_sum", "first_loss"):
            assert rel_err(m[key], jm[key]) <= RTOL, (key, m[key], jm[key])
    want = step_runs["jax_grads"]
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    got = ranks[0]["grads"]
    assert set(got) == set(want)
    for name, g in got.items():
        assert rel_err(g.numpy(), want[name].numpy(), floor) <= RTOL, name
    if "model" in STEP_CASES[case]:  # each rank holds half of the experts
        full = sum(w.numel() * 4 for n, w in want.items() if ".mlp." in n)
        assert [r["expert_bytes"] for r in ranks] == [full // 2] * len(ranks)


@torch.no_grad()
def test_per_rank_capacity_misses_jax_where_global_routing_does_not(step_runs):
    """Routing each data rank's rows on their own (capacity, slot order and
    router loss over the rank's rows: the port's one-rank routing, which
    equals JAX's on the same rows) misses JAX's loss a microbatch by more
    than 1e-3; the port's DP 2 step (above) holds it within 1e-5."""
    (x, y), tcfg = step_runs["batch"], CodonGPTConfig(**MODEL)
    model = params_from_jax(step_runs["tree"], tcfg, "cpu")
    total = 0.0
    for g in range(G):
        numer = denom = aux = 0.0
        for r in range(2):
            xr, yr = (torch.from_numpy(a[g, r::2]).long() for a in (x, y))
            _, loss, extra = port_gpt.forward(model, tcfg, xr, yr, train=True,
                                              return_aux=True)
            n = float((yr != 0).sum())
            numer, denom = numer + float(loss) * n, denom + n
            aux += float(extra["moe_aux_loss"]) / 2
        total += numer / denom + MODEL["moe_aux_weight"] * aux
    want = step_runs["jax_metrics"]["total_loss_sum"]
    assert abs(total - want) / G > 1e-3
    got = step_runs["ranks"]["dp2_odd_b"][0]["metrics"][0]["total_loss_sum"]
    assert rel_err(got, want) <= RTOL


