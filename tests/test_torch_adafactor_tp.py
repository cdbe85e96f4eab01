"""Adafactor under tensor parallelism against JAX's one-device optax, on the CPU.

The model is 2 layers at ``n_embd`` 128 with 4 heads and a fused QKV, so the
query, key, value, MLP and ``attn.proj`` leaves are factored (their two
largest axes are >= 128). Under a model axis of 2 the ``attn.proj`` leaf is
(L, 128, 128) globally but (L, 64, 128) on a rank (its fan-in splits), and
the query, key and value leaves (L, 128, 64): read from a rank's shape they
would not be factored. The ranks run through
``genomics_lm_torch.parallel.launch.spawn`` (gloo over a ``file://`` store,
the torch-only ``parallel/workers.py`` in each child).

- One float32 group step (dropout 0, G 2 x B 4 x T 32, uneven PAD) from the
  same ``params_from_jax`` weights under TP 2, TP 2 + sequence parallelism
  and DP 2 x TP 2 with ZeRO-1 (one world-4 launch), against JAX's group step
  with ``optimizer: adafactor`` (``optax.adafactor(lr,
  multiply_by_parameter_scale=False)`` in each label group): every
  statistic, merged from the ranks into the JAX leaves, within 1e-5 of
  optax's (relative to the leaf's largest; a leaf whose gradient is
  rounding noise, ~1e-12 of the model's largest squared gradient, is held
  at that floor); the updated weights within 1e-5 wherever the gradient is
  above rounding noise (at step 1 an unfactored leaf's update is g / |g|,
  whose sign rounding noise decides, as for AdamW in
  ``test_torch_parallel.py``). In the same world-4 launch, PP 2 x TP 2 (one
  layer a stage, the pipeline's whole-group cross-entropy, no termination
  head) against optax's Adafactor on JAX's gradient of that loss: there a
  stacked split leaf's RMS sums its squares over both axes.
- The train CLI with ``optimizer: adafactor`` under ``--tensor_parallel 2``
  for one epoch, then resumed at world 1 for a second: its losses equal the
  one-process run's within 1e-5, and the TP checkpoint's statistics equal
  the one-process checkpoint's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.ops.losses import cross_entropy_parts
from genomics_lm_tpu.training import optim as jax_optim
from genomics_lm_tpu.training import train_step as jax_step
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.parallel import launch, workers
from genomics_lm_torch.parallel.tensor_parallel import TPContext, shard_model
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training import optim
from genomics_lm_torch.training.train_codon_lm import main as train_cli
from genomics_lm_torch.utils.weights import params_from_jax, state_dict_from_jax

RTOL = 1e-5
G, B, T = 2, 4, 32
RUN_CFG = {"lr": 1e-3, "lr_embedding": 2e-3, "min_lr": 1e-4, "weight_decay": 0.05,
           "warmup_steps": 1, "scheduler": "cosine", "optimizer": "adafactor",
           "shard_optimizer_state": False}
MODEL = dict(vocab_size=68, block_size=T, n_layer=2, n_head=4, n_embd=128, dropout=0.0,
             label_smoothing=0.05, sep_id=3, fused_qkv=True, termination_aux=True)
LOSS = dict(termination_enabled=True, termination_weight=0.5, termination_stop_ids=(2,))
CASES = {
    "tp2": ({"data": 1, "model": 2}, {}),
    "tp2_sp": ({"data": 1, "model": 2}, {"residual_sharding": ("data", "model")}),
    "dp2_tp2_zero1": ({"data": 2, "model": 2}, {"shard_optimizer_state": True}),
    "pp2_tp2": ({"data": 1, "pipe": 2, "model": 2}, {}),
}
PP_MODEL = dict(MODEL, termination_aux=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def step_batch(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(4, 68, (G, B, T)).astype(np.int32)
    x[..., ::9] = 3
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    y[0, 1, 4:] = 0
    y[0, 3, :] = 0
    y[1, 0, 20:] = 0
    y[1, 2, 30:] = 0
    return x, y


def flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def optax_statistics(state) -> dict:
    """Each leaf's Adafactor statistics from optax's multi-transform state:
    ``{path: {"v_row", "v_col"}}`` for a factored leaf, ``{path: {"v"}}``
    otherwise (optax keeps a (1,) placeholder for the other kind)."""
    from optax._src.factorized import FactoredState

    found = []

    def visit(node):
        if isinstance(node, FactoredState):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)
        elif isinstance(node, dict):
            for child in node.values():
                visit(child)

    visit(state)
    stats: dict = {}
    for fs in found:
        # a leaf of another label group is a MaskedNode: an empty array here
        rows, cols, full = (flat(jax.tree.map(np.asarray, t,
                                              is_leaf=lambda x: isinstance(x, optax.MaskedNode)))
                            for t in (fs.v_row, fs.v_col, fs.v))
        for path, v in full.items():
            if np.size(v) == 0:
                continue
            if np.size(v) == 1 and np.size(rows[path]) > 1:
                stats[path] = {"v_row": rows[path], "v_col": cols[path]}
            else:
                stats[path] = {"v": v}
    return stats


@pytest.fixture(scope="module")
def runs():
    jcfg = JaxConfig(**MODEL)
    params = jax_gpt.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    x, y = step_batch()
    jbundle = jax_optim.build_optimizer(RUN_CFG, params, total_steps=10)
    jloss = jax_step.LossConfig(**LOSS)
    capture = optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    _, jgrads, _ = jax_step.make_train_step(jcfg, jloss, capture)(
        params, capture.init(params), batch, jax.random.PRNGKey(0), jnp.float32(1.0))
    new_params, opt_state, _ = jax_step.make_train_step(jcfg, jloss, jbundle.tx)(
        params, jbundle.tx.init(params), batch, jax.random.PRNGKey(0), jnp.float32(1.0))
    # the pipeline's objective: cross-entropy over the whole group
    pcfg = JaxConfig(**PP_MODEL)
    pparams = {k: v for k, v in params.items() if k != "termination_head"}

    def group_ce(p):
        parts = [cross_entropy_parts(jax_gpt.forward(p, pcfg, jnp.asarray(x[g]))[0],
                                     jnp.asarray(y[g]), ignore_index=0,
                                     label_smoothing=MODEL["label_smoothing"])
                 for g in range(G)]
        return sum(n for n, _ in parts) / sum(d for _, d in parts)

    pgrads = jax.grad(group_ce)(pparams)
    pbundle = jax_optim.build_optimizer(RUN_CFG, pparams, total_steps=10)
    pupdates, pstate = pbundle.tx.update(pgrads, pbundle.tx.init(pparams), pparams)
    pp_params = optax.apply_updates(pparams, pupdates)
    ptree = jax.tree.map(np.asarray, pparams)
    specs = {case: {"axes": axes, "model": dict(MODEL, **{k: v for k, v in over.items()
                                                          if k == "residual_sharding"}),
                    "tree": tree, "groups": [(x, y)], "total_steps": 10, "loss": LOSS,
                    "run_cfg": dict(RUN_CFG, **{k: v for k, v in over.items()
                                                if k == "shard_optimizer_state"}),
                    "return_grads": True, "return_optimizer": True}
             for case, (axes, over) in CASES.items()}
    two = launch.spawn(workers.group_steps, 2, [specs["tp2"], specs["tp2_sp"]], device="cpu")
    specs["pp2_tp2"].update(model=PP_MODEL, tree=ptree, loss={})
    four = launch.spawn(workers.group_steps, 4, [specs["dp2_tp2_zero1"], specs["pp2_tp2"]],
                        device="cpu")
    tcfg, pp_cfg = CodonGPTConfig(**MODEL), CodonGPTConfig(**PP_MODEL)
    want = {"params": state_dict_from_jax(jax.tree.map(np.asarray, new_params), tcfg),
            "grads": state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg),
            "stats": optax_statistics(opt_state), "tcfg": tcfg}
    return {
        case: dict(want, got=got) for case, got in (
            ("tp2", two[0][0]), ("tp2_sp", two[0][1]), ("dp2_tp2_zero1", four[0][0]))
    } | {"pp2_tp2": {
        "params": state_dict_from_jax(jax.tree.map(np.asarray, pp_params), pp_cfg),
        "grads": state_dict_from_jax(jax.tree.map(np.asarray, pgrads), pp_cfg),
        "stats": optax_statistics(pstate), "tcfg": pp_cfg, "got": four[0][1]}}


def rel_err(got, want, floor=0.0) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), floor, 1e-30)


def test_a_leaf_factored_globally_is_not_factored_on_a_rank():
    """The premise of the cases below: at d128 under TP 2 the rank's own
    ``attn.proj``, query, key and value leaves are below optax's 128, and
    the rank's optimizer still factors them, from the global shape."""
    tcfg = CodonGPTConfig(**MODEL)
    full = params_from_jax(jax.tree.map(
        np.asarray, jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**MODEL))), tcfg, "cpu")
    whole = {leaf.path: tuple(leaf.gather().shape) for leaf in optim.model_leaves(full)}
    ctx = TPContext(group=None, rank=0, size=2)
    rank = shard_model(full, ctx, copy_model=True)
    names = {id(p): n for n, p in rank.named_parameters()}
    local = {leaf.path: (tuple(leaf.gather().shape), optim.leaf_tp_axis(leaf, ctx.layout, names))
             for leaf in optim.model_leaves(rank)}
    for path in ("blocks/attn/proj/w", "blocks/attn/query/w", "blocks/attn/key/w",
                 "blocks/attn/value/w"):
        shape, axis = local[path]
        assert optim._factored_dims(whole[path]) is not None, path
        assert optim._factored_dims(shape) is None, path
        assert shape[axis] * 2 == whole[path][axis], path
    assert local["blocks/attn/proj/w"][1] == 1  # fan-in
    assert local["blocks/attn/query/w"][1] == 2  # fan-out: the rank's heads


@pytest.mark.parametrize("case", list(CASES))
def test_group_step_matches_optax_adafactor(runs, case):
    ref = runs[case]
    got = ref["got"]
    stats = got["optimizer"]
    assert stats["format"] == "adafactor/by-jax-leaf/v1" and stats["count"] == 1
    want = ref["stats"]
    assert set(stats["state"]) == set(want)
    # the leaves factored globally stay factored in the merged state
    assert set(stats["state"]["blocks/attn/proj/w"]) == {"v_row", "v_col"}
    floor = 1e-12 * max(float(np.abs(v).max()) for st in want.values() for v in st.values())
    for path, st in want.items():
        assert set(stats["state"][path]) == set(st), path
        for key, w in st.items():
            g = np.asarray(stats["state"][path][key])
            assert g.shape == np.shape(w), (path, key, g.shape, np.shape(w))
            assert rel_err(g, w, floor) <= RTOL, (case, path, key, rel_err(g, w, floor))
    grads = ref["grads"]
    noise = 1e-3 * max(float(w.abs().max()) for w in grads.values())
    tree = state_dict_from_jax(got["tree"], ref["tcfg"])
    for name, p in ref["params"].items():
        real = grads[name].abs() > noise
        diff = (tree[name] - p).abs()
        assert float((diff * real).max()) <= RTOL, (case, name)


BLOCK = 32


def write_fixture(tmp):
    rng = np.random.default_rng(0)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", 24), ("val", 8)):
        X = np.zeros((n, BLOCK), np.int32)
        X[:, 0] = rng.integers(4, 68, n)
        for t in range(1, BLOCK):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        X[:, ::11] = 3
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 0
        Y[: n // 3, -7:] = 0
        np.savez(tmp / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp / "itos.txt")


def write_config(tmp, epochs):
    cfg = dict(train_npz=str(tmp / "train.npz"), val_npz=str(tmp / "val.npz"),
               block_size=BLOCK, n_layer=2, n_head=4, n_embd=128, fused_qkv=True,
               dropout=0.0, batch_size=6, grad_accum_steps=2, lr=1e-3, min_lr=1e-4,
               warmup_steps=1, epochs=epochs, seed=1337, run_id="run",
               early_stop_patience=0, prefetch_batches=0, save_epochs=True,
               optimizer="adafactor", scheduler_total_steps=4)
    path = tmp / f"cfg_e{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def cli(tmp, config, root, *extra):
    return ["--config", str(config), "--run_root", str(tmp / root), "--device", "cpu", *extra]


def epoch_record(path) -> dict:
    return tckpt.load_checkpoint(path)


def test_tp_adafactor_checkpoint_resumes_at_world_one(tmp_path):
    write_fixture(tmp_path)
    one, two = write_config(tmp_path, 1), write_config(tmp_path, 2)
    assert train_cli(cli(tmp_path, two, "single")) == 0
    out = launch.spawn(workers.train_cli, 2,
                       cli(tmp_path, one, "tp", "--mesh_devices", "2", "--tensor_parallel", "2"),
                       device="cpu")
    assert [r["rc"] for r in out] == [0, 0]
    ckpts = "run/checkpoints"
    tp1 = epoch_record(tmp_path / "tp" / ckpts / "epoch_1.npz")
    single1 = epoch_record(tmp_path / "single" / ckpts / "epoch_1.npz")
    # the TP checkpoint holds the whole leaves' statistics, as one process's
    want = single1["optimizer"]["state"]
    floor = 1e-12 * max(float(np.abs(v).max()) for st in want.values() for v in st.values())
    assert set(tp1["optimizer"]["state"]) == set(want)
    for path, st in want.items():
        for key, w in st.items():
            assert rel_err(tp1["optimizer"]["state"][path][key], w, floor) <= RTOL, (path, key)
    assert train_cli(cli(tmp_path, two, "tp", "--resume",
                         str(tmp_path / "tp" / ckpts / "last.npz"))) == 0
    for epoch in (1, 2):
        got = epoch_record(tmp_path / "tp" / ckpts / f"epoch_{epoch}.npz")
        ref = epoch_record(tmp_path / "single" / ckpts / f"epoch_{epoch}.npz")
        for key in ("train_loss", "val_loss"):
            assert abs(float(got[key]) - float(ref[key])) <= RTOL * abs(float(ref[key])), (
                epoch, key, got[key], ref[key])
