"""The shape encoder's fit and the fusion CLI against the JAX package, on the CPU.

- ``models/biophysics.py::train_encoder`` from JAX's ``init_encoder``
  weights, with the arguments of JAX's own test (64 samples of 8 codons, 3
  epochs, batch 16): every epoch's loss and the final weights within 1e-5
  of JAX's ``train_encoder`` (optax ``adamw``'s weight decay is 1e-4, not
  torch's default 1e-2).
- ``training/train_biophysics_fusion.py`` and ``scripts/train_biophysics_fusion.py``
  with ``--lm_config`` (2 layers of d32): the encoder checkpoints hold the
  same ``{"encoder", "losses"}`` tree, and the shape-guided runs' curves
  match within 1e-5. Both start from the same weights: the port's encoder
  fit from JAX's ``init_encoder`` (``train_encoder``'s ``init``), and both
  trainers from one JAX init checkpoint through ``transfer_from``, as
  ``tests/test_torch_hybrid_pipeline.py`` does.
- Each package's trainer reads the other's encoder checkpoint: a JAX run
  on the port's encoder and a port run on JAX's hold it unchanged and
  track the chained runs' first epoch within 1e-5.
"""

from __future__ import annotations

import csv
import functools

import jax
import numpy as np
import pytest
import yaml

import scripts.train_biophysics_fusion as jax_fusion
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import biophysics as jax_bio
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_tpu.training import loop as jax_loop
from genomics_lm_torch.models import biophysics
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training import loop
from genomics_lm_torch.training import train_biophysics_fusion as fusion

RTOL = 1e-5
ENC_ARGS = dict(num_samples=64, seq_len_codons=8, epochs=3, batch_size=16)


def assert_rel(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-12)
    assert err <= rtol, f"{what}: {err} > {rtol}"


def jax_init_tree(seed=0) -> dict:
    return jax.tree.map(np.asarray, jax_bio.init_encoder(jax.random.PRNGKey(seed)))


def test_train_encoder_matches_jax():
    jparams, jlosses = jax_bio.train_encoder(**ENC_ARGS)
    encoder, losses = biophysics.train_encoder(**ENC_ARGS, init=jax_init_tree(), device="cpu")
    assert len(losses) == len(jlosses) == 3 and losses[-1] < losses[0]
    assert_rel(losses, jlosses, RTOL, "epoch losses")
    got = biophysics.encoder_tree(encoder)
    for conv in ("conv1", "conv2"):
        for leaf in ("w", "b"):
            assert_rel(got[conv][leaf], jparams[conv][leaf], RTOL, f"{conv}/{leaf}")


def test_train_encoder_without_init_is_seeded():
    a, la = biophysics.train_encoder(num_samples=16, seq_len_codons=4, epochs=1, device="cpu")
    b, lb = biophysics.train_encoder(num_samples=16, seq_len_codons=4, epochs=1, device="cpu")
    assert la == lb
    for conv in ("conv1", "conv2"):
        assert np.array_equal(biophysics.encoder_tree(a)[conv]["w"],
                              biophysics.encoder_tree(b)[conv]["w"])


BLOCK = 32
LM = dict(block_size=BLOCK, n_layer=2, n_head=2, n_embd=32, dropout=0.0)
CLI_ENC = ["--num_samples", "64", "--seq_len_codons", "8", "--epochs", "2", "--seed", "0"]


def write_data(tmp):
    rng = np.random.default_rng(0)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", 16), ("val", 8)):
        X = np.zeros((n, BLOCK), np.int32)
        X[:, 0] = 1
        X[:, 1] = rng.integers(4, 68, n)
        for t in range(2, BLOCK):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 2
        np.savez(tmp / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp / "itos.txt")


def lm_config(tmp, run_id, epochs=2, **extra):
    cfg = dict(train_npz=str(tmp / "train.npz"), val_npz=str(tmp / "val.npz"), **LM,
               batch_size=4, grad_accum_steps=2, lr=1e-3, min_lr=1e-4, warmup_steps=1,
               epochs=epochs, seed=0, run_id=run_id, early_stop_patience=0, **extra)
    path = tmp / f"{run_id}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def curves(run_dir) -> np.ndarray:
    with (run_dir / "scores" / "curves.csv").open() as f:
        rows = list(csv.reader(f))[1:]
    return np.array([[float(v) for v in r[1:3]] for r in rows])


def epoch_losses(run_dir) -> np.ndarray:
    out = []
    for epoch in range(1, 10):
        path = run_dir / "checkpoints" / f"epoch_{epoch}.npz"
        if not path.exists():
            break
        p = tckpt.load_checkpoint(path)
        out.append([float(p["train_loss"]), float(p["val_loss"])])
    return np.array(out)


@pytest.fixture(scope="module")
def fusion_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fusion")
    write_data(tmp)
    init = tmp / "init" / "checkpoints" / "init.npz"
    init.parent.mkdir(parents=True)
    jcfg = JaxConfig(vocab_size=68, **LM, use_shape_guidance=True)
    jckpt.save_checkpoint({"model": jax_gpt.init(jax.random.PRNGKey(3), jcfg)}, init)
    write_itos(tmp / "init" / "itos.txt")
    runs = tmp / "runs"
    mp = pytest.MonkeyPatch()
    # both trainers from the init checkpoint, into one runs root
    for mod in (jax_loop, loop):
        mp.setattr(mod, "run_training", functools.partial(
            mod.run_training, transfer_from=str(init), run_root=str(runs)))
    mp.setattr(biophysics, "train_encoder",
               functools.partial(biophysics.train_encoder, init=jax_init_tree()))
    try:
        enc = {"jax": tmp / "enc_jax.npz", "port": tmp / "enc_port.npz"}
        jcfg_path, _ = lm_config(tmp, "jax", save_epochs=True)
        tcfg_path, _ = lm_config(tmp, "port", save_epochs=True)
        assert jax_fusion.main(["--out_checkpoint", str(enc["jax"]), "--lm_config",
                                str(jcfg_path), *CLI_ENC]) == 0
        assert fusion.main(["--out_checkpoint", str(enc["port"]), "--lm_config",
                            str(tcfg_path), *CLI_ENC, "--device", "cpu"]) == 0
    finally:
        mp.undo()
    # each trainer on the other package's encoder checkpoint, one epoch
    _, cross_j = lm_config(tmp, "jax_on_port", epochs=1, use_shape_guidance=True,
                           shape_encoder_checkpoint=str(enc["port"]))
    _, cross_t = lm_config(tmp, "port_on_jax", epochs=1, use_shape_guidance=True,
                           shape_encoder_checkpoint=str(enc["jax"]), save_epochs=True)
    assert jax_loop.run_training(cross_j, transfer_from=str(init),
                                 run_root=str(runs))["status"] == "completed"
    assert loop.run_training(cross_t, transfer_from=str(init), run_root=str(runs),
                             device="cpu")["status"] == "completed"
    return {"enc": enc, "runs": runs}


def test_encoder_checkpoints_match(fusion_runs):
    enc = fusion_runs["enc"]
    j, t = jckpt.load_checkpoint(enc["jax"]), tckpt.load_checkpoint(enc["port"])
    assert set(j) == set(t) == {"encoder", "losses"}
    assert len(t["losses"]) == 2 and t["losses"][-1] < t["losses"][0]
    assert_rel(t["losses"], j["losses"], RTOL, "encoder losses")
    for conv in ("conv1", "conv2"):
        for leaf in ("w", "b"):
            assert np.asarray(t["encoder"][conv][leaf]).dtype == np.float32
            assert_rel(t["encoder"][conv][leaf], j["encoder"][conv][leaf], RTOL, conv + leaf)
    # each package reads the other's file as its own
    assert set(jckpt.load_checkpoint(enc["port"])["encoder"]) == {"conv1", "conv2"}
    assert set(tckpt.load_checkpoint(enc["jax"])["encoder"]) == {"conv1", "conv2"}


def test_chained_shape_guided_runs_match(fusion_runs):
    runs = fusion_runs["runs"]
    want, got = curves(runs / "jax"), curves(runs / "port")
    assert want.shape == got.shape == (2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-3)  # curves.csv prints 4 decimals
    full_j = np.array([[float(jckpt.load_checkpoint(runs / "jax" / "checkpoints" /
                                                    f"epoch_{e}.npz")[k])
                        for k in ("train_loss", "val_loss")] for e in (1, 2)])
    assert_rel(epoch_losses(runs / "port"), full_j, RTOL, "epoch losses")
    payload = tckpt.load_checkpoint(runs / "port" / "checkpoints" / "last.npz")
    assert payload["cfg"]["use_shape_guidance"] is True
    assert payload["cfg"]["shape_encoder_checkpoint"].endswith("enc_port.npz")
    enc = tckpt.load_checkpoint(fusion_runs["enc"]["port"])["encoder"]
    np.testing.assert_array_equal(payload["model"]["shape_encoder"]["conv1"]["w"],
                                  enc["conv1"]["w"])  # frozen


def test_each_trainer_reads_the_other_encoder(fusion_runs):
    runs, enc = fusion_runs["runs"], fusion_runs["enc"]
    jp = jckpt.load_checkpoint(runs / "jax_on_port" / "checkpoints" / "last.npz")
    tp = tckpt.load_checkpoint(runs / "port_on_jax" / "checkpoints" / "last.npz")
    for payload, source in ((jp, enc["port"]), (tp, enc["jax"])):
        tree = jckpt.load_checkpoint(source)["encoder"]
        for conv in ("conv1", "conv2"):
            np.testing.assert_array_equal(np.asarray(payload["model"]["shape_encoder"][conv]["w"]),
                                          tree[conv]["w"])
    first = epoch_losses(runs / "port")[0]
    assert_rel([tp["train_loss"], tp["val_loss"]], first, RTOL, "port on JAX's encoder")
    assert_rel([jp["train_loss"], jp["val_loss"]], first, RTOL, "JAX on the port's encoder")
