"""PyTorch port of the NoProp codon LM and its trainer against the JAX package.

The same numpy weights (``models/noprop.py::params_from_jax`` of a JAX
``noprop.init`` tree) and token ids go through ``genomics_lm_tpu.models.
noprop`` and the port on the CPU (2 layers, d 32, float32). ``forward``
(with and without target embeddings) agrees within 1e-5, and
``noprop_loss`` with zero noise and its gradients within 1e-5 relative
(the loss sums squared errors over D and is of order 100, where a float32
ulp is 1.5e-5; each gradient is held to the larger of its own max and a
thousandth of the model's); the layer-local topology leaves each block's gradient
free of every later block's loss and of the head's cross-entropy. The
trainer runs its lifecycle, writes a checkpoint JAX reads, and resumes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import noprop as jax_noprop
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_torch.models import noprop
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training.train_noprop import main as noprop_cli

ATOL = 1e-5
KW = dict(vocab_size=68, block_size=32, n_layer=2, n_head=4, n_embd=32, dropout=0.0, sep_id=3)


def make_pair(seed=0):
    jcfg, tcfg = JaxConfig(**KW), CodonGPTConfig(**KW)
    params = jax_noprop.init(jax.random.PRNGKey(seed), jcfg)
    model = noprop.params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return params, jcfg, model, tcfg


def batch(seed=1, B=3, T=24):
    x = np.random.default_rng(seed).integers(4, 68, (B, T)).astype(np.int32)
    x[0, 9] = 3
    y = np.roll(x, -1, axis=1)
    y[:, -3:] = 0
    return x, y


def test_forward_matches_jax():
    params, jcfg, model, tcfg = make_pair()
    x, y = batch()
    targets = np.random.default_rng(2).standard_normal((3, 24, 32)).astype(np.float32)
    for t in (None, targets):
        want_logits, want_preds = jax_noprop.forward(params, jcfg, x, t)
        with torch.no_grad():
            logits, preds = noprop.forward(model, tcfg, torch.from_numpy(x).long(),
                                           None if t is None else torch.from_numpy(t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL)
        for g, w in zip(preds, want_preds):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_noprop_loss_and_gradients_match_jax_with_zero_noise():
    params, jcfg, model, tcfg = make_pair(seed=3)
    x, y = batch(seed=4)

    def loss_fn(p):
        return jax_noprop.noprop_loss(p, jcfg, x, y, jax.random.PRNGKey(0), noise_sigma=0.0)

    (want, want_parts), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    total, parts = noprop.noprop_loss(model, tcfg, torch.from_numpy(x).long(),
                                      torch.from_numpy(y).long(), torch.Generator(),
                                      noise_sigma=0.0)
    assert float(total.detach()) == pytest.approx(float(want), rel=ATOL)
    assert float(parts["ce"].detach()) == pytest.approx(float(want_parts["ce"]), rel=ATOL)
    np.testing.assert_allclose([float(m.detach()) for m in parts["block_mse"]],
                               [float(m) for m in want_parts["block_mse"]], rtol=ATOL)
    total.backward()
    grads = noprop.params_to_jax(model)  # the tree layout, to hold the gradients
    got = {leaf.path: leaf.gather(lambda p: p.grad).numpy() for leaf in noprop.noprop_leaves(model)}
    want = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                want[f"{prefix}{k}"] = np.asarray(v)

    walk(want_grads)
    assert set(got) == set(want) and set(want) == {leaf.path for leaf in noprop.noprop_leaves(model)}
    assert grads.keys() == want_grads.keys()
    floor = 1e-3 * max(np.abs(g).max() for g in want.values())
    for path, g in want.items():
        err = np.abs(got[path] - g).max() / max(np.abs(g).max(), floor)
        assert err <= ATOL, f"{path}: {err}"


def test_layer_local_gradients():
    """Block 0's parameters get no gradient from block 1's loss or the
    head's CE; block 1's none from the CE: each loss reaches only its own
    block (and the embeddings it reads)."""
    _, _, model, tcfg = make_pair(seed=5)
    x, y = batch(seed=6)
    _, parts = noprop.noprop_loss(model, tcfg, torch.from_numpy(x).long(),
                                  torch.from_numpy(y).long(), torch.Generator().manual_seed(0))
    blocks = [list(b.parameters()) for b in model.blocks]
    for later, loss in ((1, parts["block_mse"][1]), (2, parts["ce"])):
        grads = torch.autograd.grad(loss, [p for b in blocks for p in b], retain_graph=True,
                                    allow_unused=True)
        flat = iter(grads)
        for i, params in enumerate(blocks):
            gs = [next(flat) for _ in params]
            if i < later:
                assert all(g is None or not g.any() for g in gs), (later, i)
            elif later == 1:
                assert any(g is not None and g.any() for g in gs)
    own = torch.autograd.grad(parts["block_mse"][0], blocks[0], retain_graph=True)
    assert any(g.any() for g in own)


def write_corpus(tmp_path):
    rng = np.random.default_rng(8)
    for name, n in (("train", 48), ("val", 16)):
        X = rng.integers(4, 68, (n, 32)).astype(np.int32)
        X[:, 0] = 1
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 2
        np.savez(tmp_path / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp_path / "itos.txt")
    cfg = tmp_path / "noprop.yaml"
    cfg.write_text(f"train_npz: {tmp_path / 'train.npz'}\nval_npz: {tmp_path / 'val.npz'}\n"
                   "block_size: 32\nn_layer: 2\nn_head: 2\nn_embd: 32\nbatch_size: 8\n"
                   "epochs: 2\nlearning_rate: 0.001\nseed: 3\n")
    return cfg


def test_trainer_runs_resumes_and_writes_a_jax_checkpoint(tmp_path, capsys):
    cfg = write_corpus(tmp_path)
    argv = ["--config", str(cfg), "--run_root", str(tmp_path / "runs"), "--run_id", "np",
            "--device", "cpu"]
    assert noprop_cli(argv) == 0
    run = tmp_path / "runs" / "np"
    last = run / "checkpoints" / "last.npz"
    for name in ("checkpoints/best.npz", "itos.txt", "vocabulary.json", "scores/metrics.json",
                 "run_complete.json"):
        assert (run / name).exists(), name
    cfg.write_text(cfg.read_text().replace("epochs: 2", "epochs: 3"))
    assert noprop_cli(argv + ["--resume", str(last)]) == 0
    rows = (run / "scores" / "curves.csv").read_text().strip().splitlines()
    assert rows[0] == "epoch,train_ce,val_ce" and len(rows) == 4
    losses = [float(v) for r in rows[1:] for v in r.split(",")[1:]]
    assert np.isfinite(losses).all()
    assert capsys.readouterr().out.count("[noprop] epoch") == 3
    payload = jckpt.load_checkpoint(last)  # JAX reads the port's checkpoint
    assert payload["epoch"] == 3
    jcfg = JaxConfig(**dict(KW, n_head=2))
    x = np.load(tmp_path / "val.npz")["X"][:4]
    want, _ = jax_noprop.forward(jax.tree.map(jnp.asarray, payload["model"]), jcfg, x)
    model = noprop.params_from_jax(payload["model"], CodonGPTConfig(**dict(KW, n_head=2)), "cpu")
    with torch.no_grad():
        got, _ = noprop.forward(model, model.cfg, torch.from_numpy(x).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
