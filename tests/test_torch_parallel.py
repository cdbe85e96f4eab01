"""Data and tensor parallelism of the port against the JAX package, on the CPU.

The port runs one process per rank (``torch.distributed`` over gloo, a
``file://`` store per launch), so every multi-rank check spawns its ranks
through ``genomics_lm_torch.parallel.launch.spawn``, which runs the
torch-only workers of ``genomics_lm_torch/parallel/workers.py``: the child
imports neither this module nor JAX. JAX's references run here, on one
device.

- ``make_mesh`` keeps JAX's axis arithmetic and errors.
- Every leaf's tensor-parallel spec equals JAX's ``tp_spec``, each rank's
  slice of the port's parameters is the slice of the JAX leaf that spec
  names, and the optimizer each rank builds under ZeRO-1 holds every moment
  once, a rank at most JAX's ``opt_state_sharding`` share plus one unit:
  separate and fused QKV, GQA, SwiGLU, LoRA and int8 trees.
- DP 2, DP 2 + ZeRO-1, TP 2 and TP 2 + sequence parallelism: one group
  step from the same ``params_from_jax`` weights, dropout 0, with uneven
  PAD across the ranks, against JAX's single-device group step: metrics
  and gradients within 1e-5, updated weights within 1e-5 wherever the
  gradient is above rounding noise.
- The train CLI at ``--mesh_devices 2`` (ZeRO-1): one epoch, then a resume,
  against the one-process run's losses within 1e-5; the world-2 ZeRO-1
  ``last.npz`` resumed at world 1, and a TP 2 run's resumed at world 1,
  give the one-process run's next epoch.
- A SIGTERM sent to one rank stops both ranks at the same group, one
  preemption checkpoint is written, and both resume to completion.
"""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.ops.quant import quantize_params as jax_quantize
from genomics_lm_tpu.parallel import mesh as jax_mesh
from genomics_lm_tpu.parallel import sharding as jax_sharding
from genomics_lm_tpu.training import lora as jax_lora
from genomics_lm_tpu.training import optim as jax_optim
from genomics_lm_tpu.training import train_step as jax_step
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.parallel import workers, launch, sharding
from genomics_lm_torch.parallel.data_parallel import DPContext
from genomics_lm_torch.parallel import mesh as port_mesh
from genomics_lm_torch.parallel import tensor_parallel as tpl
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training.optim import build_optimizer
from genomics_lm_torch.training.train_codon_lm import main as train_cli
from genomics_lm_torch.utils.weights import jax_leaves, params_from_jax, state_dict_from_jax

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- meshes -------------------------------------------------------------------

MESH_CASES = [
    (8, None), (8, {"data": -1, "model": 2}), (8, {"data": 4, "model": 2}),
    (8, {"data": 2, "model": -1}), (4, {"model": 4}), (6, {"data": -1, "model": 4}),
    (8, {"data": -1, "model": -1}), (8, {"data": 3, "model": 2}),
]


@pytest.mark.parametrize("n, axes", MESH_CASES, ids=[str(c) for c in range(len(MESH_CASES))])
def test_make_mesh_matches_jax(n, axes):
    try:
        want = jax_mesh.make_mesh(n, axes=axes)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port_mesh.make_mesh(devices=list(range(8))[:n], axes=axes)
        assert str(got.value) == str(exc)
        return
    got = port_mesh.make_mesh(devices=list(range(8))[:n], axes=axes)
    assert got.shape == dict(want.shape)
    assert tuple(got.axis_names) == tuple(want.axis_names)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)


def test_initialize_distributed_strict_raises_and_default_degrades(capsys):
    bad = "tcp://256.0.0.1:1"  # an address that cannot be reached
    with pytest.raises(RuntimeError, match="distributed bring-up failed"):
        port_mesh.initialize_distributed(bad, strict=True, device="cpu", world_size=2,
                                         rank=1, timeout_s=1)
    assert not port_mesh.initialize_distributed(bad, device="cpu", world_size=2, rank=1,
                                                timeout_s=1)
    assert "bring-up FAILED" in capsys.readouterr().err
    assert port_mesh.world() == (0, 1)


# --- the sharding rules ---------------------------------------------------------

RULE_CASES = {
    "qkv": {},
    "fused_gqa": {"fused_qkv": True, "n_kv_head": 2},
    "swiglu_gqa": {"use_swiglu": True, "n_kv_head": 2, "tie_embeddings": False},
    "lora": {"lora": True},
    "fused_lora": {"fused_qkv": True, "lora": True},
    "int8": {"int8": True},
    "fused_int8": {"fused_qkv": True, "int8": True},
}


def rule_tree(case):
    over = dict(RULE_CASES[case])
    lora, int8 = over.pop("lora", False), over.pop("int8", False)
    kw = dict(vocab_size=68, block_size=32, n_layer=2, n_head=4, n_embd=32, dropout=0.0)
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(0), jcfg)
    if lora:
        params = jax_lora.add_lora_adapters(params, jax.random.PRNGKey(1), rank=4,
                                            targets="attn+mlp")
        params = jax.tree.map(lambda a: a + 0.01, params)  # nonzero lora_b too
    if int8:
        params = jax_quantize(params)
    return jax.tree.map(np.asarray, params), tcfg


def flat_with_paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_with_paths(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_tp_and_zero1_rules_match_jax(case):
    tree, tcfg = rule_tree(case)
    leaves = flat_with_paths(tree)
    jmesh = jax_mesh.make_mesh(8, axes={"data": 4, "model": 2})
    want_opt = flat_with_paths(jax_sharding.opt_state_sharding(
        tree, jmesh, tp_axis="model", zero1=True))
    for path, leaf in leaves.items():
        assert tuple(sharding.tp_spec(path, leaf.shape, 2, "model")) == tuple(
            jax_sharding.tp_spec(path, leaf.shape, 2, "model")), path

    # each rank's slice of every port parameter is the spec's slice of its
    # leaf; and ZeRO-1 over a data axis of 4, in the optimizer each rank
    # builds, holds every moment of the rank's slices once, each data rank
    # about a quarter: at most JAX's ZeRO-1 share a device plus one unit
    full = params_from_jax(tree, tcfg, "cpu")
    names = {id(p): n for n, p in full.named_parameters()}
    local_index = {}
    for r in range(2):
        local = tpl.shard_model(full, tpl.TPContext(None, r, 2), copy_model=True)
        lp = dict(local.named_parameters())
        jax_share = 0.0
        for leaf in jax_leaves(full, tcfg):
            path = tuple(leaf.path.split("/"))
            value = leaves[path]
            spec = jax_sharding.tp_spec(path, value.shape, 2, "model")
            if "model" in tuple(spec):
                dim = tuple(spec).index("model")
                value = np.split(value, 2, axis=dim)[r]
            data = 4 if "data" in tuple(want_opt[path].spec) else 1
            for i, (p, rows, t) in enumerate(leaf.parts):
                part = value[i] if leaf.stacked else value
                part = part.T if t else part
                got = lp[names[id(p)]].detach().numpy()
                if rows is not None:  # a fused QKV's block: the local block's rows
                    split = local.tp.layout[names[id(p)]]
                    got = got[rows.start // (2 if split else 1):
                              rows.stop // (2 if split else 1)]
                np.testing.assert_array_equal(got, part, err_msg=f"{leaf.path} rank {r}")
                local_index[names[id(p)]] = True
                if p.requires_grad:  # two float32 moments
                    jax_share += 8 * part.size / data
        if case.endswith("int8"):  # an int8 tree serves; the trainer takes no int8 weights
            continue
        trainable = [p for p in local.parameters() if p.requires_grad]
        held = []
        for d in range(4):
            bundle = build_optimizer(dict(RUN_CFG, shard_optimizer_state=True), local, 10,
                                     dp=DPContext(None, d, 4))
            for p in trainable:
                p.grad = torch.zeros_like(p)
            bundle.optimizer.step()  # the moments of the parameters this rank owns
            held.append(sum(t.numel() * t.element_size()
                            for st in bundle.optimizer.state.values()
                            for k, t in st.items() if k != "step"))
        unit = max(8 * p.numel() for p in trainable)
        assert sum(held) == sum(8 * p.numel() for p in trainable), (r, held)
        assert max(held) <= jax_share + unit, (r, held, jax_share)
    assert set(local_index) == {n for n, _ in full.named_parameters()}


def test_zero1_owners_deal_each_unit_once_and_balance():
    units = [(f"u{i}", n) for i, n in enumerate([900, 500, 400, 300, 300, 100, 7, 1])]
    owner = sharding.zero1_owners(units, 2)
    assert set(owner) == {u for u, _ in units}
    load = [sum(n for u, n in units if owner[u] == r) for r in range(2)]
    assert abs(load[0] - load[1]) <= 100
    assert owner == sharding.zero1_owners(units, 2)  # the same on every rank


# --- group steps against JAX's one device ----------------------------------------

G, B, T = 2, 4, 32
RUN_CFG = {"lr": 1e-3, "lr_embedding": 2e-3, "min_lr": 1e-4, "weight_decay": 0.05,
           "warmup_steps": 1, "scheduler": "cosine", "shard_optimizer_state": False}
STEP_MODEL = dict(vocab_size=68, block_size=T, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
                  label_smoothing=0.05, sep_id=3, fused_qkv=True, n_kv_head=2,
                  termination_aux=True)
LOSS = dict(termination_enabled=True, termination_weight=0.5, termination_stop_ids=(2,))


def step_batch(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(4, 68, (G, B, T)).astype(np.int32)
    x[..., ::9] = 3
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    # uneven PAD across the ranks (rank 0 takes rows 0 and 2, rank 1 rows 1 and 3)
    y[0, 1, 4:] = 0
    y[0, 3, :] = 0
    y[1, 0, 20:] = 0
    y[1, 2, 30:] = 0
    return x, y


STEP_CASES = {
    "dp2": ({"data": 2}, {}),
    "dp2_zero1": ({"data": 2}, {"shard_optimizer_state": True}),
    "tp2": ({"data": 1, "model": 2}, {}),
    "tp2_sp": ({"data": 1, "model": 2}, {"residual_sharding": ("data", "model")}),
}


@pytest.fixture(scope="module")
def step_runs():
    kw = dict(STEP_MODEL)
    jcfg = JaxConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    x, y = step_batch()
    jbundle = jax_optim.build_optimizer(RUN_CFG, params, total_steps=10)
    jloss = jax_step.LossConfig(**LOSS)
    jstep = jax_step.make_train_step(jcfg, jloss, jbundle.tx)
    capture = optax_capture()
    jgrad_step = jax_step.make_train_step(jcfg, jloss, capture)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    new_params, _, jmetrics = jstep(params, jbundle.tx.init(params), batch,
                                    jax.random.PRNGKey(0), jnp.float32(1.0))
    _, jgrads, _ = jgrad_step(params, capture.init(params), batch, jax.random.PRNGKey(0),
                              jnp.float32(1.0))
    specs = []
    for axes, over in STEP_CASES.values():
        model = dict(STEP_MODEL)
        if "residual_sharding" in over:
            model["residual_sharding"] = over["residual_sharding"]
        specs.append({"axes": axes, "model": model, "tree": tree, "groups": [(x, y)],
                      "run_cfg": dict(RUN_CFG, **{k: v for k, v in over.items()
                                                  if k == "shard_optimizer_state"}),
                      "total_steps": 10, "loss": LOSS, "return_grads": True})
    # at dropout 0.1 (flash attention's plain version on the CPU): the
    # unsplit model with no mesh, and TP 2 + SP from the same generator seed
    drop = dict(STEP_MODEL, dropout=0.1, attention_impl="flash")
    for axes, model in ((None, drop), ({"data": 1, "model": 2},
                                       dict(drop, residual_sharding=("data", "model")))):
        specs.append({"axes": axes, "model": model, "tree": tree, "groups": [(x, y)],
                      "run_cfg": RUN_CFG, "total_steps": 10, "loss": LOSS,
                      "return_grads": True, "seed": 5})
    out = launch.spawn(workers.group_steps, 2, specs, device="cpu")
    tcfg = CodonGPTConfig(**STEP_MODEL)
    n = len(STEP_CASES)
    return {
        "jax_params": state_dict_from_jax(jax.tree.map(np.asarray, new_params), tcfg),
        "jax_grads": state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg),
        "jax_metrics": {k: float(v) for k, v in jmetrics.items()},
        "tcfg": tcfg, "ranks": {case: [r[i] for r in out]
                                for i, case in enumerate(STEP_CASES)},
        "dropout": {"unsplit": out[0][n], "tp2_sp": [r[n + 1] for r in out]},
    }


def optax_capture():
    import optax

    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def rel_err(got, want, floor=1e-12) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), floor)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_group_step_matches_jax_single_device(step_runs, case):
    ranks = step_runs["ranks"][case]
    jm = step_runs["jax_metrics"]
    for r in ranks:  # every rank reads the global metrics
        m = r["metrics"][0]
        assert m["applied"] == 1.0
        assert m["nonpad_tokens"] == jm["nonpad_tokens"]
        assert m["committed_microbatches"] == jm["committed_microbatches"] == G
        for key in ("total_loss_sum", "next_loss_sum", "first_loss"):
            assert rel_err(m[key], jm[key]) <= RTOL, (key, m[key], jm[key])
    grads = ranks[0]["grads"]
    want = step_runs["jax_grads"]
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        assert rel_err(g.numpy(), want[name].numpy(), floor) <= RTOL, name
    # AdamW's first step is lr * g / (|g| + eps): where g is rounding noise it
    # may take either sign, so only weights with a real gradient are held
    tcfg = step_runs["tcfg"]
    got = state_dict_from_jax(ranks[0]["tree"], tcfg)
    for name, p in step_runs["jax_params"].items():
        real = want[name].abs() > floor
        diff = (got[name] - p).abs()
        assert float((diff * real).max()) <= RTOL, name
        assert float(diff.max()) <= 2 * RUN_CFG["lr_embedding"] + RTOL, name
    if case == "dp2_zero1":  # each rank holds about half of the moments
        full = sum(2 * p.numel() * 4 for p in step_runs["jax_params"].values())
        held = [r["state_bytes"] for r in ranks]
        assert sum(held) < 1.05 * full + 64 * 8 and max(held) < 0.6 * full, held


def test_tp_dropout_drops_as_the_unsplit_model(step_runs):
    """At dropout 0.1 a TP 2 + SP group step equals the unsplit model's:
    each rank keys its heads' attention masks on their global indices, and
    the residual masks are drawn for the whole sequence."""
    ref = step_runs["dropout"]["unsplit"]
    ranks = step_runs["dropout"]["tp2_sp"]
    for r in ranks:
        for key in ("total_loss_sum", "next_loss_sum", "first_loss"):
            assert rel_err(r["metrics"][0][key], ref["metrics"][0][key]) <= RTOL, key
    want = ref["grads"]
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, g in ranks[0]["grads"].items():
        assert rel_err(g.numpy(), want[name].numpy(), floor) <= RTOL, name
    tcfg = step_runs["tcfg"]
    got = state_dict_from_jax(ranks[0]["tree"], tcfg)
    for name, p in state_dict_from_jax(ref["tree"], tcfg).items():
        real = want[name].abs() > floor
        assert float(((got[name] - p).abs() * real).max()) <= RTOL, name


def test_a_data_mesh_of_one_rank_runs_the_collectives_and_equals_no_mesh():
    """One rank under a ``data`` mesh of 1 issues the data-parallel
    collectives (the loss shares', metrics' and gradient's all-reduces and
    ZeRO-1's all-gather, counted) and gathers to the writer, and its group
    step equals the meshless step's bit for bit."""
    tree = params_to_jax_tree(STEP_MODEL)
    x, y = step_batch()
    spec = {"axes": None, "model": STEP_MODEL, "tree": tree, "groups": [(x, y)],
            "run_cfg": dict(RUN_CFG, shard_optimizer_state=True), "total_steps": 10,
            "loss": LOSS, "return_grads": True}
    ref, one = launch.spawn(workers.group_steps, 1,
                            [spec, dict(spec, axes={"data": 1}, time_collectives=True)],
                            device="cpu")[0]
    assert ref["collectives"] == 0 and one["collectives"] >= 4
    assert one["metrics"] == ref["metrics"]
    for name, g in ref["grads"].items():
        assert torch.equal(one["grads"][name], g), name
    for path, leaf in flat_with_paths(ref["tree"]).items():
        np.testing.assert_array_equal(flat_with_paths(one["tree"])[path], leaf,
                                      err_msg=str(path))


def params_to_jax_tree(kw: dict) -> dict:
    params = jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**kw))
    return jax.tree.map(np.asarray, params)


def test_dropout_heads_key_a_slice_of_heads_as_the_whole_model():
    """A call holding heads h0 .. h0 + Hq - 1 of H (``dropout_heads``) drops
    as those heads of the whole call: the keep mask, the einsum path and
    flash attention's plain version (forward and gradients)."""
    from genomics_lm_torch.ops import flash_attention as fa
    from genomics_lm_torch.ops.attention import sdpa

    B, H, Hkv, T, D, rate = 2, 4, 2, 40, 8, 0.3
    seed = torch.tensor([1234], dtype=torch.int32)
    full = fa.philox_keep(seed, B, H, T, T, rate)
    for h0 in (0, 2):
        np.testing.assert_array_equal(fa.philox_keep(seed, B, 2, T, T, rate, (h0, H)),
                                      full[:, h0:h0 + 2])
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, T, D, generator=gen, requires_grad=True)
    k = torch.randn(B, Hkv, T, D, generator=gen, requires_grad=True)
    v = torch.randn(B, Hkv, T, D, generator=gen, requires_grad=True)
    dout = torch.randn(B, H, T, D, generator=gen)
    for attend in (lambda *a, **kw: sdpa(*a, dropout_rate=rate, seed=seed, **kw),
                   lambda *a, **kw: fa.flash_attention(*a, dropout_rate=rate, seed=seed,
                                                       **kw)):
        want = attend(q, k, v)
        wq, wk, wv = torch.autograd.grad(want, (q, k, v), dout)
        for r in range(2):  # rank r of 2: heads 2r, 2r + 1 over kv head r
            sl = slice(2 * r, 2 * r + 2)
            qr, kr, vr = (t.detach()[:, s].clone().requires_grad_()
                          for t, s in ((q, sl), (k, slice(r, r + 1)), (v, slice(r, r + 1))))
            got = attend(qr, kr, vr, dropout_heads=(2 * r, H))
            torch.testing.assert_close(got, want[:, sl], rtol=0, atol=1e-6)
            gq, gk, gv = torch.autograd.grad(got, (qr, kr, vr), dout[:, sl])
            torch.testing.assert_close(gq, wq[:, sl], rtol=0, atol=1e-6)
            torch.testing.assert_close(gk, wk[:, r:r + 1], rtol=0, atol=1e-6)
            torch.testing.assert_close(gv, wv[:, r:r + 1], rtol=0, atol=1e-6)
        # keyed on its local heads, rank 1 would drop as heads 0 and 1 do
        got = attend(q.detach()[:, 2:], k.detach()[:, 1:], v.detach()[:, 1:])
        assert not torch.allclose(got, want.detach()[:, 2:], atol=1e-3)


# --- the trainer --------------------------------------------------------------------

BLOCK = 32


def make_fixture(tmp_path, n_train=48, n_val=12):
    rng = np.random.default_rng(0)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", n_train), ("val", n_val)):
        X = np.zeros((n, BLOCK), np.int32)
        X[:, 0] = rng.integers(4, 68, n)
        for t in range(1, BLOCK):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        X[:, ::11] = 3
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 0
        Y[: n // 3, -7:] = 0  # pad tails, uneven over the ranks' rows
        np.savez(tmp_path / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp_path / "itos.txt")


def write_config(tmp_path, name, epochs, **kw):
    cfg = dict(train_npz=str(tmp_path / "train.npz"), val_npz=str(tmp_path / "val.npz"),
               block_size=BLOCK, n_layer=2, n_head=2, n_embd=16, dropout=0.0,
               label_smoothing=0.05, batch_size=6, grad_accum_steps=2, lr=1e-3,
               min_lr=1e-4, warmup_steps=2, epochs=epochs, seed=1337, run_id=name,
               early_stop_patience=0, prefetch_batches=0,
               scheduler_total_steps=8)  # one schedule whether a run stops at 1 or 2
    cfg.update(kw)
    path = tmp_path / f"{name}_e{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def cli_argv(tmp_path, config, root, resume=None, *extra):
    argv = ["--config", str(config), "--run_root", str(tmp_path / root), "--device", "cpu"]
    if resume is not None:
        argv += ["--resume", str(resume)]
    return argv + list(extra)


def run_losses(run_dir) -> dict:
    """Each epoch's (train, val) losses at full precision: the epoch
    checkpoints' records."""
    out = {}
    for f in sorted((run_dir / "checkpoints").glob("epoch_*.npz")):
        p = tckpt.load_checkpoint(f)
        out[int(p["epoch"])] = (float(p["train_loss"]), float(p["val_loss"]))
    return out


def assert_losses_close(got: dict, want: dict):
    assert set(got) == set(want), (got, want)
    for epoch in want:
        for a, b in zip(got[epoch], want[epoch]):
            assert abs(a - b) <= RTOL * abs(b), (epoch, got, want)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """One process for 2 epochs; 2 ranks (ZeRO-1) for 1 epoch, then a
    2-rank resume to 2; a TP 2 run of 1 epoch; each resumed at world 1; and
    a 2-rank run that rank 0 signals after its first group, then resumed.
    The ranks' runs share two launches (``workers.each``)."""
    tmp = tmp_path_factory.mktemp("trainer")
    make_fixture(tmp)
    flags = {"save_epochs": True, "shard_optimizer_state": True}
    one = write_config(tmp, "run", 2, **flags)
    assert train_cli(cli_argv(tmp, one, "single")) == 0
    dp1 = write_config(tmp, "run", 1, **flags)
    sig = write_config(tmp, "sig", 2, save_epochs=True)
    mesh = ("--mesh_devices", "2")
    out = launch.spawn(workers.each, 2, [
        ("train_cli_sigterm", cli_argv(tmp, sig, "sig", None, *mesh)),
        ("train_cli", cli_argv(tmp, dp1, "dp", None, *mesh)),
        ("train_cli", cli_argv(tmp, dp1, "tp", None, *mesh, "--tensor_parallel", "2"))],
        device="cpu")
    sigterm = [r[0]["rc"] for r in out]
    assert [[r[i]["rc"] for r in out] for i in (1, 2)] == [[0, 0], [0, 0]]
    shutil.copytree(tmp / "dp", tmp / "dp_to_one")
    last = "run/checkpoints/last.npz"
    sig_last = tmp / "sig" / "sig" / "checkpoints" / "last.npz"
    sig_payload = tckpt.load_checkpoint(sig_last)
    tp_payload = tckpt.load_checkpoint(tmp / "tp" / last)
    out = launch.spawn(workers.each, 2, [
        ("train_cli", cli_argv(tmp, sig, "sig", sig_last, *mesh)),
        ("train_cli", cli_argv(tmp, one, "dp", tmp / "dp" / last, *mesh))], device="cpu")
    assert [[r[i]["rc"] for r in out] for i in (0, 1)] == [[0, 0], [0, 0]]
    assert train_cli(cli_argv(tmp, one, "dp_to_one", tmp / "dp_to_one" / last)) == 0
    assert train_cli(cli_argv(tmp, one, "tp", tmp / "tp" / last)) == 0
    return {name: tmp / name / "run" for name in ("single", "dp", "dp_to_one", "tp")} | {
        "tp_payload": tp_payload, "sigterm_rc": sigterm, "sig_payload": sig_payload,
        "sig": tmp / "sig" / "sig"}


def test_cli_mesh_devices_2_epoch_and_resume_match_one_process(trainer_runs):
    want = run_losses(trainer_runs["single"])
    assert_losses_close(run_losses(trainer_runs["dp"]), want)
    curves = [np.loadtxt(trainer_runs[k] / "scores" / "curves.csv", delimiter=",", skiprows=1)
              for k in ("dp", "single")]
    assert curves[0].shape == (2, 7)
    np.testing.assert_allclose(curves[0], curves[1], rtol=RTOL, atol=2e-4)  # 4 printed decimals


def test_zero1_checkpoint_resumes_at_world_one_with_the_same_next_epoch(trainer_runs):
    payload = tckpt.load_checkpoint(trainer_runs["dp_to_one"] / "checkpoints" / "epoch_1.npz")
    single = tckpt.load_checkpoint(trainer_runs["single"] / "checkpoints" / "epoch_1.npz")
    # full arrays in the one-process layout: the same leaves, moments of every parameter
    assert set(payload["optimizer"]["state"]) == set(single["optimizer"]["state"])
    for key in ("exp_avg", "exp_avg_sq"):
        # a key bias's gradient is rounding noise: each moment is held to
        # the larger of its own max and a thousandth of the model's
        floor = 1e-3 * max(float(np.abs(st[key]).max())
                           for st in single["optimizer"]["state"].values())
        for name, st in single["optimizer"]["state"].items():
            got = payload["optimizer"]["state"][name][key]
            assert got.shape == st[key].shape
            assert rel_err(got, st[key], floor) <= 1e-4, (name, key)
    assert_losses_close(run_losses(trainer_runs["dp_to_one"]), run_losses(trainer_runs["single"]))


def test_tp_checkpoint_holds_full_arrays_and_resumes_at_world_one(trainer_runs):
    single = tckpt.load_checkpoint(trainer_runs["single"] / "checkpoints" / "epoch_1.npz")
    payload = trainer_runs["tp_payload"]
    flat_tp = flat_with_paths(payload["model"])
    for path, leaf in flat_with_paths(single["model"]).items():
        assert flat_tp[path].shape == leaf.shape, path
    assert_losses_close(run_losses(trainer_runs["tp"]), run_losses(trainer_runs["single"]))


def test_sigterm_on_one_rank_stops_both_and_resumes(trainer_runs):
    # only rank 0 received the signal: it exits 128 + SIGTERM, rank 1 cleanly
    assert trainer_runs["sigterm_rc"] == [128 + 15, 0]
    payload = trainer_runs["sig_payload"]
    assert payload["checkpoint_reason"] == "preempted"
    assert payload["step"] == 1  # both ranks stopped after the first group
    run = trainer_runs["sig"]  # resumed by both ranks to completion
    assert (run / "run_complete.json").exists()
    assert len((run / "scores" / "curves.csv").read_text().splitlines()) == 3


def test_cli_refuses_a_mesh_that_does_not_match_the_world(tmp_path):
    make_fixture(tmp_path)
    cfg = write_config(tmp_path, "run", 1)
    with pytest.raises(ValueError, match="must equal the world size 1"):
        train_cli(cli_argv(tmp_path, cfg, "runs", None, "--mesh_devices", "2"))
    # expert parallelism runs (tests/test_torch_expert_parallel.py), but one
    # process cannot lay its model axis of 2 (JAX's make_mesh error)
    moe = write_config(tmp_path, "moe", 1, moe_experts=4)
    with pytest.raises(ValueError, match="not divisible by 2"):
        train_cli(cli_argv(tmp_path, moe, "runs", None, "--tensor_parallel", "2"))
    assert not (tmp_path / "runs").exists()
