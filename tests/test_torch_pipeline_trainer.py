"""The trainer's pipeline branch (``training/loop.py`` with a ``pipe`` mesh
axis) on the CPU, through the train CLI.

The ranks run through ``genomics_lm_torch.parallel.launch.spawn`` (gloo over
a ``file://`` store; each child runs the torch-only ``parallel/workers.py``),
on ``configs/stage2.6_large_12L8H_d512_pp4.yaml`` cut to 4 layers of d32,
float32, dropout 0:

- ``--mesh_devices 4 --pipeline_stages 2`` (DP 2 x PP 2): one epoch and a
  resume with the same stage count, bit for bit the straight run; the same
  checkpoint resumed under 4 stages within 1e-5 of it; at
  ``grad_accum_steps`` 1 a resume at world size 1 within 1e-5 of the
  one-process run. Checkpoints hold the merged layout and record
  ``train_objective: "group_ce"``. With ``optimizer: adafactor`` (ZeRO-1 by
  leaf, the RMS clip of a stacked leaf over the stages) the epoch's weights
  and merged Adafactor statistics are the one-process run's within 1e-5,
  and a resume at world size 1 follows it.
- A resume that would switch objectives at ``grad_accum_steps`` 3 raises
  ``RunLifecycleError``; each objective the pipeline does not run raises
  JAX's ``ValueError`` (``genomics_lm_tpu/training/loop.py:437-451``).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch
import yaml

from genomics_lm_torch.parallel import launch, workers
from genomics_lm_torch.parallel import mesh as port_mesh
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training.lifecycle import RunLifecycleError
from genomics_lm_torch.training.loop import run_training
from genomics_lm_torch.training.train_codon_lm import main as train_cli

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- the trainer ---------------------------------------------------------------------

BLOCK = 32


def write_corpus(tmp_path, n_train=24, n_val=6):
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
        Y[: n // 3, -7:] = 0
        np.savez(tmp_path / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp_path / "itos.txt")


def pp_recipe(tmp_path, name, epochs, **kw):
    """``configs/stage2.6_large_12L8H_d512_pp4.yaml`` cut for the CPU: 4
    layers, d32, B 6, float32, dropout 0; ``pipeline_stages`` from the
    command line."""
    with open("configs/stage2.6_large_12L8H_d512_pp4.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.pop("pipeline_stages")
    cfg.update(train_npz=str(tmp_path / "train.npz"), val_npz=str(tmp_path / "val.npz"),
               block_size=BLOCK, n_layer=4, n_head=2, n_embd=32, dropout=0.0,
               attention_impl="xla", compute_dtype="float32", use_mmap_dataset=False,
               batch_size=6, grad_accum_steps=3, warmup_steps=1, epochs=epochs, run_id=name,
               save_epochs=True, early_stop_patience=0, prefetch_batches=0,
               scheduler_total_steps=8, lr=1e-3, min_lr=1e-4, shard_optimizer_state=True)
    for key in ("flash_block_q", "flash_block_k"):
        cfg.pop(key)
    cfg.update(kw)
    path = tmp_path / f"{name}_e{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def argv(tmp_path, cfg, root, *extra):
    return ["--config", str(cfg), "--run_root", str(tmp_path / root), "--device", "cpu",
            *extra]


def run_losses(run_dir) -> dict:
    out = {}
    for f in sorted((run_dir / "checkpoints").glob("epoch_*.npz")):
        p = tckpt.load_checkpoint(f)
        out[int(p["epoch"])] = (float(p["train_loss"]), float(p["val_loss"]))
    return out


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_trainer")
    write_corpus(tmp)
    pp2 = ("--mesh_devices", "4", "--pipeline_stages", "2")
    one = pp_recipe(tmp, "run", 2)
    e1 = pp_recipe(tmp, "run", 1)
    g1 = {e: pp_recipe(tmp, "g1", e, grad_accum_steps=1) for e in (1, 2)}
    ada = {e: pp_recipe(tmp, "ada", e, grad_accum_steps=1, optimizer="adafactor")
           for e in (1, 2)}
    assert train_cli(argv(tmp, g1[2], "g1_single")) == 0
    assert train_cli(argv(tmp, ada[2], "ada_single")) == 0
    out = launch.spawn(workers.each, 4, [
        ("train_cli", argv(tmp, one, "straight", *pp2)),
        ("train_cli", argv(tmp, e1, "same", *pp2)),
        ("train_cli", argv(tmp, g1[1], "g1", *pp2)),
        ("train_cli", argv(tmp, ada[1], "ada", *pp2))], device="cpu")
    assert [[r[i]["rc"] for r in out] for i in range(4)] == [[0] * 4] * 4
    ada_first = tckpt.load_checkpoint(tmp / "ada" / "ada" / "checkpoints" / "last.npz")
    assert train_cli(argv(tmp, ada[2], "ada", "--resume",
                          str(tmp / "ada" / "ada" / "checkpoints" / "last.npz"))) == 0
    shutil.copytree(tmp / "same", tmp / "other")
    last = "run/checkpoints/last.npz"
    first = tckpt.load_checkpoint(tmp / "same" / last)
    out = launch.spawn(workers.each, 4, [
        ("train_cli", argv(tmp, one, "same", *pp2, "--resume", str(tmp / "same" / last))),
        ("train_cli", argv(tmp, one, "other", "--mesh_devices", "4", "--pipeline_stages", "4",
                           "--resume", str(tmp / "other" / last)))], device="cpu")
    assert [[r[i]["rc"] for r in out] for i in range(2)] == [[0] * 4] * 2
    assert train_cli(argv(tmp, g1[2], "g1", "--resume",
                          str(tmp / "g1" / "g1" / "checkpoints" / "last.npz"))) == 0
    return {"tmp": tmp, "first": first, "one": one, "ada_first": ada_first}


def test_checkpoint_is_merged_and_records_the_group_objective(trainer_runs):
    payload = trainer_runs["first"]
    assert payload["train_objective"] == "group_ce"
    assert payload["model"]["blocks"]["ln1"]["scale"].shape == (4, 32)
    assert set(payload["optimizer"]["state"]) >= {"blocks.3.ln1.weight", "tok_emb.weight"}


def test_resume_with_the_same_stage_count_is_bit_for_bit(trainer_runs):
    tmp = trainer_runs["tmp"]
    straight = tckpt.load_checkpoint(tmp / "straight" / "run" / "checkpoints" / "last.npz")
    resumed = tckpt.load_checkpoint(tmp / "same" / "run" / "checkpoints" / "last.npz")
    assert run_losses(tmp / "same" / "run") == run_losses(tmp / "straight" / "run")
    flat = lambda t, p=(): {k: v for kk, vv in t.items() for k, v in (  # noqa: E731
        flat(vv, p + (kk,)).items() if isinstance(vv, dict) else [(p + (kk,), vv)])}
    for path, leaf in flat(straight["model"]).items():
        np.testing.assert_array_equal(flat(resumed["model"])[path], leaf, err_msg=str(path))


def test_resume_under_another_stage_count_and_at_world_one(trainer_runs):
    tmp = trainer_runs["tmp"]
    for got, want in ((tmp / "other" / "run", tmp / "straight" / "run"),
                      (tmp / "g1" / "g1", tmp / "g1_single" / "g1")):
        got, want = run_losses(got), run_losses(want)
        assert set(got) == set(want) == {1, 2}
        for epoch in want:
            for a, b in zip(got[epoch], want[epoch]):
                assert abs(a - b) <= RTOL * abs(b), (got, want)


def flat_tree(tree, path=()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(flat_tree(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


KEY_BIAS = ("blocks", "attn", "key", "b")


def test_adafactor_over_the_stages_is_the_one_process_run(trainer_runs):
    tmp = trainer_runs["tmp"]
    got = trainer_runs["ada_first"]
    want = tckpt.load_checkpoint(tmp / "ada_single" / "ada" / "checkpoints" / "epoch_1.npz")
    assert got["optimizer"]["format"] == want["optimizer"]["format"] == "adafactor/by-jax-leaf/v1"
    assert got["optimizer"]["count"] == want["optimizer"]["count"] > 0
    for name, tree in (("model", "model"), ("statistics", "optimizer")):
        g = flat_tree(got[tree] if tree == "model" else got[tree]["state"])
        w = flat_tree(want[tree] if tree == "model" else want[tree]["state"])
        assert set(g) == set(w), name
        for path, leaf in w.items():
            assert np.shape(g[path]) == np.shape(leaf), (name, path)
            # the loss does not depend on the key bias (it shifts each query's
            # logits by one constant): its gradient is rounding noise, which
            # Adafactor scales up to whole steps
            assert path == KEY_BIAS or rel_close(g[path], leaf), (name, path)
    got, want = run_losses(tmp / "ada" / "ada"), run_losses(tmp / "ada_single" / "ada")
    assert set(got) == set(want) == {1, 2}
    for epoch in want:
        for a, b in zip(got[epoch], want[epoch]):
            assert abs(a - b) <= RTOL * abs(b), (got, want)


def rel_close(got, want) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= RTOL * max(float(np.abs(want).max()), 1e-12)


def test_resume_that_switches_objectives_raises(trainer_runs):
    tmp = trainer_runs["tmp"]
    three = pp_recipe(tmp, "run", 3)
    last = tmp / "straight" / "run" / "checkpoints" / "last.npz"
    with pytest.raises(RunLifecycleError, match="from group_ce to microbatch_mean"):
        train_cli(argv(tmp, three, "straight", "--resume", str(last)))


UNSUPPORTED = {
    "multi_offset_loss": {"multi_offset_targets": [2]},
    "termination_loss": {"termination_aux": True, "termination_loss_enabled": True},
    "replay_loss": {"termination_aux": True, "replay_loss_enabled": True,
                    "replay_data": "missing.jsonl"},
    "shape_guidance": {"use_shape_guidance": True},
    "moe": {"moe_experts": 4},
}


@pytest.mark.parametrize("objective", list(UNSUPPORTED))
def test_unsupported_objectives_raise_jax_value_error(tmp_path, objective):
    write_corpus(tmp_path)
    cfg = yaml.safe_load(pp_recipe(tmp_path, "run", 1, **UNSUPPORTED[objective]).read_text())
    mesh = port_mesh.make_mesh(devices=[0, 1], axes={"data": 1, "pipe": 2})
    with pytest.raises(ValueError, match=r"pipeline parallelism supports the plain "
                                         rf"next-token CE objective only; disable: \['{objective}'\]"):
        run_training(cfg, run_root=str(tmp_path / "runs"), device="cpu", mesh=mesh)
    assert not (tmp_path / "runs").exists()
