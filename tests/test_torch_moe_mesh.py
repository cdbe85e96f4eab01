"""A MoE model under a mesh through the port's entry points, against JAX.

Ranks run through ``genomics_lm_torch.parallel.launch.spawn`` (gloo over a
``file://`` store, the torch-only ``parallel/workers.py`` in each child).
Float32, dropout 0:

- The train CLI on the EP recipe (cut to small widths, capacity 0.5) at
  ``--mesh_devices 4 --tensor_parallel 2`` (DP 2 x EP 2) and at
  ``--mesh_devices 4`` (a data mesh), each one epoch, resumed at world 1,
  against the one-process run within 1e-5.
- The serving engine at tensor parallel 2 on a MoE model (each rank 2 of
  the 4 experts), token for token with JAX's meshless engine, greedy and
  speculative K 2.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import yaml

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.serving import engine as jax_engine
from genomics_lm_torch.parallel import launch, workers
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training.train_codon_lm import main as train_cli

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- the trainer --------------------------------------------------------------------

BLOCK = 32


def write_corpus(tmp_path, n_train=48, n_val=12):
    rng = np.random.default_rng(0)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", n_train), ("val", n_val)):
        X = np.zeros((n, BLOCK), np.int32)
        X[:, 0] = rng.integers(4, 68, n)
        for t in range(1, BLOCK):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 0
        Y[: n // 3, -7:] = 0
        np.savez(tmp_path / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp_path / "itos.txt")


def ep_recipe(tmp_path, name, epochs):
    """``configs/stage2.6_moe_4e_top2_d512_ep2.yaml`` with its widths, depth,
    batch and schedule cut for the CPU and capacity binding (0.5)."""
    with open("configs/stage2.6_moe_4e_top2_d512_ep2.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(train_npz=str(tmp_path / "train.npz"), val_npz=str(tmp_path / "val.npz"),
               block_size=BLOCK, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
               attention_impl="xla", compute_dtype="float32", use_mmap_dataset=False,
               flash_block_q=None, flash_block_k=None, batch_size=8, grad_accum_steps=2,
               warmup_steps=1, epochs=epochs, run_id=name, save_epochs=True,
               early_stop_patience=0, prefetch_batches=0, moe_capacity_factor=0.5,
               scheduler_total_steps=6, lr=1e-3, min_lr=1e-4)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    path = tmp_path / f"{name}_e{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_losses(run_dir) -> dict:
    out = {}
    for f in sorted((run_dir / "checkpoints").glob("epoch_*.npz")):
        p = tckpt.load_checkpoint(f)
        out[int(p["epoch"])] = (float(p["train_loss"]), float(p["val_loss"]))
    return out


def test_cli_runs_the_ep_recipe_and_a_moe_data_mesh_then_resumes_at_world_one(tmp_path):
    write_corpus(tmp_path)
    argv = lambda cfg, root, *extra: ["--config", str(cfg), "--run_root",  # noqa: E731
                                      str(tmp_path / root), "--device", "cpu", *extra]
    assert train_cli(argv(ep_recipe(tmp_path, "single", 2), "single")) == 0
    e1 = {name: ep_recipe(tmp_path, name, 1) for name in ("ep", "dp")}
    out = launch.spawn(workers.each, 4, [
        ("train_cli", argv(e1["ep"], "ep", "--mesh_devices", "4", "--tensor_parallel", "2")),
        ("train_cli", argv(e1["dp"], "dp", "--mesh_devices", "4"))], device="cpu")
    assert [[r[i]["rc"] for r in out] for i in (0, 1)] == [[0, 0, 0, 0], [0, 0, 0, 0]]
    want = run_losses(tmp_path / "single" / "single")
    for name in ("ep", "dp"):
        last = tmp_path / name / name / "checkpoints" / "last.npz"
        payload = tckpt.load_checkpoint(last)
        assert payload["model"]["blocks"]["mlp"]["fc"]["w"].shape == (2, 4, 32, 128)
        assert train_cli(argv(ep_recipe(tmp_path, name, 2), name, "--resume", str(last))) == 0
        got = run_losses(tmp_path / name / name)
        assert set(got) == set(want) == {1, 2}
        for epoch in want:
            for a, b in zip(got[epoch], want[epoch]):
                assert abs(a - b) <= RTOL * abs(b), (name, got, want)


# --- serving -----------------------------------------------------------------------

SERVE_MODEL = dict(vocab_size=68, block_size=64, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
                   sep_id=3, fused_qkv=True, n_kv_head=2, attention_impl="flash",
                   moe_experts=4, moe_top_k=2)
SERVE_ENGINE = dict(slots=3, max_seq_len=48, steps_per_sync=4)


@pytest.fixture(scope="module")
def moe_drains():
    rng = np.random.default_rng(0)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, 3 + 2 * i)], 12 + i, 0.0)
            for i in range(5)]
    params = jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**SERVE_MODEL))
    tree = jax.tree.map(np.asarray, params)
    table = np.full((68, 68), 1.0 / 68)
    specs = [{"model": SERVE_MODEL, "tree": tree, "engine": SERVE_ENGINE, "requests": reqs},
             {"model": SERVE_MODEL, "tree": tree, "requests": reqs,
              "engine": dict(SERVE_ENGINE, speculative_k=2, draft_table=table)}]
    ranks = launch.spawn(workers.serve, 2, specs, device="cpu")
    eng = jax_engine.ServingEngine(params, JaxConfig(**SERVE_MODEL), **SERVE_ENGINE)
    for prompt, n, _ in reqs:
        eng.submit(prompt, n)
    return {"ranks": ranks, "jax": {rid: list(r.tokens) for rid, r in eng.run().items()},
            "budgets": [n for _, n, _ in reqs]}


@pytest.mark.parametrize("i, case", [(0, "greedy"), (1, "spec2")])
def test_tp2_engine_serves_a_moe_model_as_jax(moe_drains, i, case):
    r0, r1 = (r[i] for r in moe_drains["ranks"])
    assert r0["stats"]["tensor_parallel"] and r0["tokens"] == r1["tokens"]
    assert r0["tokens"] == moe_drains["jax"], case
    assert [len(r0["tokens"][rid]) for rid in range(5)] == moe_drains["budgets"]
