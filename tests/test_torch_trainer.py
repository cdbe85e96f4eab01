"""The port's trainer (``training/loop.py``) against the JAX package's.

On the CPU, float32:

- From the same init (a JAX checkpoint given to both through
  ``transfer_from``), dropout 0, both trainers run 2 epochs on the same
  windows; per-epoch ``train_loss``, ``val_loss`` and ``val_next_loss``
  agree within ``CURVE_RTOL`` and the two ``best.npz`` models' logits on a
  validation batch within ``LOGIT_RTOL``, relative (measured: 7.6e-7 on
  the curves, 1.3e-6 on the logits). The weights themselves differ by up
  to 2.3e-4 (lr 1e-3): both sides compute the same gradients up to the
  order of float32 sums (``test_torch_train_step.py`` holds a group's to
  1e-5), but Adam divides each gradient by its own running RMS, so an
  element whose gradient is near zero or changes sign takes a step of up
  to lr whatever its size, and a 1e-6 difference can flip that step.
  Those elements are few and carry little signal, so the logits and
  losses barely move.
- The port's ``best.npz`` loads in the JAX package, whose ``forward`` gives
  the port's logits within 1e-4; a JAX checkpoint cannot resume in the port
  (its optimizer state is optax's) and says so.
- A run stopped (after epoch 1, or mid-epoch by the wall timer) and resumed
  gives exactly the straight run's curve and weights with dropout 0.1: the
  trainer's generator state is in the checkpoint.
- The lifecycle probes of ``tests/test_trainer_e2e.py``, the OOM safeguard,
  the train CLI, and every flag the port used to refuse taking effect in a
  one-epoch run. (The mesh flags: ``tests/test_torch_parallel.py``,
  ``test_torch_expert_parallel.py`` and ``test_torch_pipeline.py``.)
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.tokenizers.codon import write_itos
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_tpu.training.loop import run_training as jax_run_training
from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training import loop
from genomics_lm_torch.training.lifecycle import RunLifecycleError
from genomics_lm_torch.training.loop import NonfiniteGroupLimitError, run_training
from genomics_lm_torch.training.train_codon_lm import main as train_cli
from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax

CURVE_RTOL = 1e-5
LOGIT_RTOL = 1e-4
JAX_LOGIT_RTOL = 1e-4
BLOCK = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one thread: these small models gain nothing
    from more, and with several test processes on the machine torch's
    spinning worker threads slow every process many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_fixture(tmp_path, n_train=64, n_val=16, block=BLOCK, seed=0):
    """Windows of a sparse bigram chain (learnable), a few with pad tails."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", n_train), ("val", n_val)):
        X = np.zeros((n, block), np.int32)
        X[:, 0] = rng.integers(4, 68, n)
        for t in range(1, block):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        X[:, ::11] = 3  # <SEP> segments
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 0
        Y[: n // 4, -5:] = 0
        np.savez(tmp_path / f"{name}.npz", X=X, Y=Y)
    write_itos(tmp_path / "itos.txt")


def base_cfg(tmp_path, **kw):
    cfg = dict(
        train_npz=str(tmp_path / "train.npz"), val_npz=str(tmp_path / "val.npz"),
        block_size=BLOCK, n_layer=2, n_head=2, n_embd=32, dropout=0.0,
        label_smoothing=0.05, batch_size=8, grad_accum_steps=2, lr=1e-3, min_lr=1e-4,
        warmup_steps=2, epochs=2, seed=1337, run_id="t-run", early_stop_patience=0,
    )
    cfg.update(kw)
    return cfg


def small_cfg(tmp_path, **kw):
    return base_cfg(tmp_path, n_layer=1, n_embd=16, **kw)


def assert_rel(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-12)
    assert err <= rtol, f"{what}: {err} > {rtol}"


def test_port_trainer_tracks_the_jax_trainer(tmp_path):
    make_fixture(tmp_path)
    jcfg = JaxConfig(vocab_size=68, block_size=BLOCK, n_layer=2, n_head=2, n_embd=32,
                     dropout=0.0, label_smoothing=0.05)
    init = tmp_path / "init.npz"
    jckpt.save_checkpoint({"model": jax_gpt.init(jax.random.PRNGKey(5), jcfg)}, init)
    cfg = base_cfg(tmp_path, save_epochs=True)
    jmeta = jax_run_training(dict(cfg, run_id="jax-run"), transfer_from=str(init),
                             run_root=str(tmp_path / "runs"))
    tmeta = run_training(dict(cfg, run_id="port-run"), transfer_from=str(init),
                         run_root=str(tmp_path / "runs"), device="cpu")
    assert jmeta["status"] == tmeta["status"] == "completed"
    assert tmeta["n_params"] == jmeta["n_params"]
    assert tmeta["consumed_train_tokens"] == jmeta["consumed_train_tokens"]
    jdir, tdir = tmp_path / "runs" / "jax-run", tmp_path / "runs" / "port-run"
    for epoch in (1, 2):
        jp = jckpt.load_checkpoint(jdir / "checkpoints" / f"epoch_{epoch}.npz")
        tp = tckpt.load_checkpoint(tdir / "checkpoints" / f"epoch_{epoch}.npz")
        assert tp["step"] == jp["step"] == 4 * epoch
        for key in ("train_loss", "val_loss", "val_next_loss", "train_next_loss"):
            assert_rel(tp[key], jp[key], CURVE_RTOL, f"epoch {epoch} {key}")
    assert tmeta["best_epoch"] == jmeta["best_epoch"] == 2

    # the two trained models, and the port's model read by JAX
    x = np.load(tmp_path / "val.npz")["X"][:4]
    jbest = jckpt.load_checkpoint(jdir / "checkpoints" / "best.npz")
    want, _ = jax_gpt.forward(jax.tree.map(jnp.asarray, jbest["model"]), jcfg, jnp.asarray(x))
    tcfg = CodonGPTConfig.from_run_config(tckpt.load_checkpoint(
        tdir / "checkpoints" / "best.npz")["cfg"])
    tbest = tckpt.load_checkpoint(tdir / "checkpoints" / "best.npz")
    model = params_from_jax(tbest["model"], tcfg, "cpu")
    with torch.no_grad():
        got, _ = codon_gpt.forward(model, tcfg, torch.from_numpy(x).long())
    assert_rel(got.numpy(), want, LOGIT_RTOL, "best.npz logits, port vs JAX training")
    read_by_jax = jckpt.load_checkpoint(tdir / "checkpoints" / "best.npz")
    jlogits, _ = jax_gpt.forward(jax.tree.map(jnp.asarray, read_by_jax["model"]), jcfg,
                                 jnp.asarray(x))
    assert_rel(jlogits, got.numpy(), JAX_LOGIT_RTOL, "the port's best.npz under JAX")

    # a JAX checkpoint resumes only in the JAX trainer
    with pytest.raises(RunLifecycleError, match="optimizer state"):
        run_training(dict(cfg, run_id="jax-run", epochs=3),
                     resume=str(jdir / "checkpoints" / "last.npz"),
                     run_root=str(tmp_path / "runs"), device="cpu")


class _StopAfter:
    """A wall timer whose ``check()`` raises after ``n`` calls (a stop at a
    group boundary in the middle of an epoch)."""

    calls = 0
    limit = 10**9

    def __init__(self, *a, **k):
        pass

    def check(self):
        type(self).calls += 1
        if type(self).calls > type(self).limit:
            raise loop.WallTimeLimitException()


@pytest.mark.parametrize("stop", ["after_epoch_1", "mid_epoch", "mid_epoch_async",
                                  "mid_epoch_lora_adafactor"])
def test_resume_reproduces_the_straight_run(tmp_path, monkeypatch, stop):
    """``mid_epoch_async`` resumes from a ``last.npz`` that the background
    writer saved after every step while training went on;
    ``mid_epoch_lora_adafactor`` with LoRA, Adafactor (its state keyed by
    JAX leaf), an active clip, remat and the auxiliary objectives."""
    make_fixture(tmp_path)
    kw = dict(dropout=0.1, save_epochs=True, scheduler_total_steps=8)
    if stop == "mid_epoch_async":
        kw.update(async_checkpointing=True, checkpoint_every_steps=1)
    if stop == "mid_epoch_lora_adafactor":
        kw.update(lora_rank=4, optimizer="adafactor", grad_clip=0.5, use_checkpoint=True,
                  termination_aux=True, termination_loss_enabled=True,
                  multi_offset_targets=[2])
    runs = str(tmp_path / "runs")
    straight = run_training(base_cfg(tmp_path, run_id="straight", **kw), run_root=runs,
                            device="cpu")
    if stop == "after_epoch_1":
        run_training(base_cfg(tmp_path, run_id="split", epochs=1, **kw), run_root=runs,
                     device="cpu")
    else:
        monkeypatch.setattr(loop, "WallTimer", _StopAfter)
        _StopAfter.calls, _StopAfter.limit = 0, 6  # after epoch 2's third group
        stopped = run_training(base_cfg(tmp_path, run_id="split", **kw), run_root=runs,
                               device="cpu")
        assert stopped["status"] == "stopped"
        monkeypatch.undo()
    last = tmp_path / "runs" / "split" / "checkpoints" / "last.npz"
    resumed = run_training(base_cfg(tmp_path, run_id="split", **kw), resume=str(last),
                           run_root=runs, device="cpu")
    assert straight["status"] == resumed["status"] == "completed"
    for epoch in (1, 2):
        a = tckpt.load_checkpoint(tmp_path / "runs" / "straight" / "checkpoints"
                                  / f"epoch_{epoch}.npz")
        b = tckpt.load_checkpoint(tmp_path / "runs" / "split" / "checkpoints"
                                  / f"epoch_{epoch}.npz")
        for key in ("train_loss", "val_loss", "val_next_loss", "step"):
            assert a[key] == b[key], (epoch, key)
    for x, y in zip(jax.tree.leaves(a["model"]), jax.tree.leaves(b["model"])):
        assert np.array_equal(x, y)
    curves = (tmp_path / "runs" / "split" / "scores" / "curves.csv").read_text()
    assert curves == (tmp_path / "runs" / "straight" / "scores" / "curves.csv").read_text()


PROBES = ["same_epochs", "nonfinite", "wall_time", "stale_checkpoint"]


@pytest.mark.parametrize("probe", PROBES)
def test_lifecycle_probes(tmp_path, probe):
    make_fixture(tmp_path)
    runs = str(tmp_path / "runs")
    ckpts = tmp_path / "runs" / "t-run" / "checkpoints"
    if probe == "same_epochs":
        run_training(small_cfg(tmp_path), run_root=runs, device="cpu")
        with pytest.raises(RunLifecycleError, match="Set epochs greater than 2"):
            run_training(small_cfg(tmp_path), resume=str(ckpts / "last.npz"),
                         run_root=runs, device="cpu")
    elif probe == "nonfinite":
        with pytest.raises(NonfiniteGroupLimitError):
            run_training(small_cfg(tmp_path, lr=1e30, warmup_steps=0, epochs=3,
                                   max_nonfinite_accumulation_groups=0),
                         run_root=runs, device="cpu")
        assert tckpt.load_checkpoint(ckpts / "last.npz")["checkpoint_reason"] == \
            "nonfinite_group_limit"
        meta = json.loads((ckpts / "meta.json").read_text())
        assert meta["status"] == "failed" and meta["accumulation_health"]["aborted_groups"] >= 1
    elif probe == "wall_time":
        meta = run_training(small_cfg(tmp_path, epochs=50, max_time_minutes=1e-6),
                            run_root=runs, device="cpu")
        assert meta["status"] == "stopped"
        payload = tckpt.load_checkpoint(ckpts / "last.npz")
        assert payload["checkpoint_reason"] == "wall_time"
        assert payload["run_progress"]["completed_epochs"] == 0
    else:  # only the newest last.npz may continue a run
        run_training(small_cfg(tmp_path), run_root=runs, device="cpu")
        with pytest.raises(RunLifecycleError, match="newest"):
            run_training(small_cfg(tmp_path, epochs=3),
                         resume=str(ckpts / "best_epoch_001.npz"),
                         run_root=runs, device="cpu")


def test_oom_saves_and_downscales_the_config(tmp_path, monkeypatch):
    make_fixture(tmp_path)
    config = tmp_path / "cfg.yaml"
    config.write_text(yaml.safe_dump(small_cfg(tmp_path)))

    def exploding(model_cfg, loss_cfg, **step_options):
        def step(*a, **k):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return step

    monkeypatch.setattr(loop, "make_train_step", exploding)
    meta = run_training(small_cfg(tmp_path), config_path=str(config),
                        run_root=str(tmp_path / "runs"), device="cpu")
    assert meta["status"] == "stopped" and "OutOfMemoryError" in meta["error"]
    assert yaml.safe_load(config.read_text())["batch_size"] == 4
    last = tmp_path / "runs" / "t-run" / "checkpoints" / "last.npz"
    assert tckpt.load_checkpoint(last)["checkpoint_reason"] == "oom"


def test_train_cli_runs_a_yaml_config_with_a_data_map(tmp_path):
    make_fixture(tmp_path)
    cfg = small_cfg(tmp_path, run_id="cli-run", async_checkpointing=True,
                    bucket_batching=True, checkpoint_every_steps=1)
    data = {"train_npz": cfg.pop("train_npz"), "val_npz": cfg.pop("val_npz")}
    config = tmp_path / "cli.yaml"
    config.write_text(yaml.safe_dump(dict(cfg, data=data)))
    argv = ["--config", str(config), "--run_root", str(tmp_path / "runs"), "--device", "cpu"]
    assert train_cli(argv) == 0
    run_dir = tmp_path / "runs" / "cli-run"
    for f in ("checkpoints/last.npz", "checkpoints/best.npz", "checkpoints/meta.json",
              "checkpoints/config.yaml", "scores/curves.csv", "scores/metrics.json",
              "itos.txt", "vocabulary.json", "run_complete.json"):
        assert (run_dir / f).exists(), f
    assert len((run_dir / "scores" / "curves.csv").read_text().splitlines()) == 3
    payload = tckpt.load_checkpoint(run_dir / "checkpoints" / "last.npz")
    assert payload["step"] == 8 and payload["optimizer"]["format"] == loop.OPTIMIZER_FORMAT
    # one process cannot lay a model or pipe axis of 2 (JAX's make_mesh error)
    with pytest.raises(ValueError, match="not divisible by 2"):
        train_cli(argv + ["--tensor_parallel", "2"])
    with pytest.raises(ValueError, match="not divisible by 2"):
        train_cli(argv + ["--pipeline_stages", "2"])


def write_replay(path):
    rng = np.random.default_rng(3)
    lines = [json.dumps({"ids": [int(t) for t in rng.integers(4, 68, 40)],
                         "labels": [{"pos": 20 + i, "class": i % 5}]}) for i in range(12)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def init_checkpoint(tmp_path, **over) -> str:
    """A port init of ``small_cfg`` (plus ``over``) as a transfer source."""
    mcfg = CodonGPTConfig.from_run_config(dict(small_cfg(tmp_path, **over), vocab_size=68))
    torch.manual_seed(11)
    path = tmp_path / "init.npz"
    tckpt.save_checkpoint({"model": params_to_jax(codon_gpt.CodonGPT(mcfg), mcfg)}, path)
    return str(path)


def one_epoch(tmp_path, run_id, transfer=None, **over):
    meta = run_training(small_cfg(tmp_path, run_id=run_id, epochs=1, **over),
                        transfer_from=transfer, run_root=str(tmp_path / "runs"), device="cpu")
    assert meta["status"] == "completed", meta.get("error")
    ckpts = tmp_path / "runs" / run_id / "checkpoints"
    return meta, tckpt.load_checkpoint(ckpts / "last.npz")


def leaves(payload) -> dict:
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(payload["model"])[0]}


def curves_header(tmp_path, run_id) -> list[str]:
    return (tmp_path / "runs" / run_id / "scores" / "curves.csv").read_text().splitlines()[0]\
        .split(",")


def moved(a: dict, b: dict) -> set[str]:
    return {p for p in a if not np.array_equal(a[p], b[p])}


PORTED_FLAGS = ["lora_rank", "lora_only", "replay_loss_enabled", "replay_data",
                "multi_offset_targets", "termination_loss_enabled", "use_shape_guidance",
                "use_checkpoint", "primary_training_contract", "grad_clip", "optimizer",
                "freeze_backbone", "unfreeze_encoder"]


@pytest.mark.parametrize("flag", PORTED_FLAGS)
def test_ported_flags_take_effect(tmp_path, capsys, flag):
    """Each option the port used to refuse, in a one-epoch CPU run; its
    numerics against JAX are in test_torch_finetune.py and
    test_torch_objectives.py."""
    make_fixture(tmp_path)
    if flag in ("lora_rank", "lora_only"):
        init = init_checkpoint(tmp_path)
        only = flag == "lora_rank"  # lora_only defaults to on with lora_rank
        _, last = one_epoch(tmp_path, "r", init, lora_rank=4,
                            **({} if only else {"lora_only": False}))
        base = leaves(tckpt.load_checkpoint(init))
        tuned = leaves(last)
        assert "[lora] rank=4 targets=attn" in capsys.readouterr().out
        state = set(last["optimizer"]["state"])
        if only:
            assert not moved(base, tuned)  # every base leaf frozen
            assert state and all("lora_a" in n or "lora_b" in n for n in state)
        else:
            assert moved(base, tuned) == set(base)
            assert {n for n in state if "lora_" not in n}
    elif flag in ("replay_loss_enabled", "replay_data"):
        path = write_replay(tmp_path / "replay.jsonl")
        meta, _ = one_epoch(tmp_path, "r", termination_aux=True, replay_loss_enabled=True,
                            replay_data=path, replay_every_microbatches=1)
        assert "train_replay_term_loss" in curves_header(tmp_path, "r")
        assert np.isfinite(meta["last_train_replay_term_loss"])
        if flag == "replay_data":  # the file is what is read
            with pytest.raises(FileNotFoundError):
                one_epoch(tmp_path, "missing", termination_aux=True, replay_loss_enabled=True,
                          replay_data=str(tmp_path / "absent.jsonl"))
    elif flag == "multi_offset_targets":
        meta, last = one_epoch(tmp_path, "r", multi_offset_targets=[2, 3])
        header = curves_header(tmp_path, "r")
        assert {"train_offset_2", "val_offset_3"} <= set(header)
        assert "offset_projs" in last["model"]
        assert meta["last_val_loss"] > meta["last_val_next_loss"]
    elif flag == "termination_loss_enabled":
        meta, _ = one_epoch(tmp_path, "r", termination_aux=True,
                            termination_loss_enabled=True)
        assert {"train_term_loss", "val_term_loss"} <= set(curves_header(tmp_path, "r"))
        assert np.isfinite(meta["last_val_term_loss"]) and meta["last_val_term_loss"] > 0
    elif flag in ("use_shape_guidance", "unfreeze_encoder"):
        init = init_checkpoint(tmp_path, use_shape_guidance=True)
        _, frozen = one_epoch(tmp_path, "frozen", init, use_shape_guidance=True)
        assert "[biophysics] shape guidance on; encoder frozen" in capsys.readouterr().out
        enc = {p for p in leaves(frozen) if p.startswith("shape_encoder")}
        assert len(enc) == 4 and np.abs(frozen["model"]["shape_proj"]["w"]).max() > 0
        # a fitted encoder from shape_encoder_checkpoint is the one trained with
        fitted = jax.tree.map(lambda a: (a * 0.5 + 0.01).astype(np.float32),
                              frozen["model"]["shape_encoder"])
        tckpt.save_checkpoint({"encoder": fitted}, tmp_path / "encoder.npz")
        _, loaded = one_epoch(tmp_path, "fitted", init, use_shape_guidance=True,
                              shape_encoder_checkpoint=str(tmp_path / "encoder.npz"))
        for p, v in leaves({"model": {"shape_encoder": fitted}}).items():
            assert np.array_equal(leaves(loaded)[p], v), p
        if flag == "unfreeze_encoder":
            _, thawed = one_epoch(tmp_path, "thawed", init, use_shape_guidance=True,
                                  unfreeze_encoder=True)
            assert moved(leaves(frozen), leaves(thawed)) >= enc
            assert {n for n in thawed["optimizer"]["state"] if n.startswith("shape_encoder")}
            assert not {n for n in frozen["optimizer"]["state"]
                        if n.startswith("shape_encoder")}
    elif flag == "use_checkpoint":
        plain_meta, plain = one_epoch(tmp_path, "plain", dropout=0.1)
        remat_meta, remat = one_epoch(tmp_path, "remat", dropout=0.1, use_checkpoint=True)
        assert remat_meta["last_val_loss"] == plain_meta["last_val_loss"]
        assert not moved(leaves(plain), leaves(remat))
    elif flag == "primary_training_contract":
        from genomics_lm_tpu.training.contracts import validate_primary_training_config
        from genomics_lm_torch.training.contracts import ContractViolation

        cfg = small_cfg(tmp_path, primary_training_contract={"role": "primary",
                                                             "protocol": "genome"})
        with pytest.raises(ContractViolation) as got:
            run_training(cfg, run_root=str(tmp_path / "runs"), device="cpu")
        with pytest.raises(ValueError) as want:
            validate_primary_training_config(cfg)
        assert got.value.violations == want.value.violations
        assert not (tmp_path / "runs").exists()
        assert loop._apply_oom_downscale(None, {"batch_size": 4}, contract_bound=True) is None
    elif flag == "grad_clip":
        _, plain = one_epoch(tmp_path, "plain")
        _, loose = one_epoch(tmp_path, "loose", grad_clip=1e9)
        _, tight = one_epoch(tmp_path, "tight", grad_clip=1e-3)
        assert not moved(leaves(plain), leaves(loose))  # inactive: the same run
        assert moved(leaves(plain), leaves(tight))
    elif flag == "optimizer":
        _, last = one_epoch(tmp_path, "r", optimizer="adafactor")
        assert last["optimizer"]["format"] == loop.ADAFACTOR_FORMAT
        assert "blocks/attn/query/w" in last["optimizer"]["state"]
        assert last["optimizer"]["count"] == last["step"] == 4
    elif flag == "freeze_backbone":
        init = init_checkpoint(tmp_path, termination_aux=True)
        _, last = one_epoch(tmp_path, "r", init, termination_aux=True,
                            termination_loss_enabled=True, freeze_backbone=True)
        changed = moved(leaves(tckpt.load_checkpoint(init)), leaves(last))
        assert changed == {"termination_head/w", "termination_head/b"}
        assert set(last["optimizer"]["state"]) == {"termination_head.weight",
                                                   "termination_head.bias"}


def test_entry_point_raises_without_cuda_unless_the_cpu_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    make_fixture(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(small_cfg(tmp_path), run_root=str(tmp_path / "runs"))


def _body(obj) -> str:
    """Source of a function or class with its docstring dropped."""
    import inspect
    import re

    src = inspect.getsource(obj)
    return re.sub(r'(:\n\s+)("""|\'\'\')[\s\S]*?\2\n', r"\1", src, count=1)


COPIED_HELPERS = {
    "config": ("config", ["ensure_path_list", "normalize_run_id", "auto_run_id",
                          "normalize_offset_weights", "load_yaml_config"]),
    "lifecycle": ("lifecycle", ["configuration_fingerprint", "checkpoint_progress",
                                "validate_curve_history", "TrainingRun", "RunProgress"]),
    "runtime": ("runtime", ["WallTimer", "PeriodicCheckpointPolicy", "GracefulPreemption",
                            "atomic_write", "RunLogger"]),
    "optim": ("optim", ["resolve_epochs"]),
    "train_step": ("train_step", ["LossConfig"]),
    "expansion": ("expansion", ["_copy_overlap", "_walk", "expand_checkpoint"]),
}


@pytest.mark.parametrize("case", list(COPIED_HELPERS))
def test_copied_training_helpers_keep_the_jax_code(case):
    import importlib

    module, names = COPIED_HELPERS[case]
    jmod = importlib.import_module(f"genomics_lm_tpu.training.{module}")
    tmod = importlib.import_module(f"genomics_lm_torch.training.{module}")
    for name in names:
        want = _body(getattr(jmod, name)).replace("genomics_lm_tpu", "genomics_lm_torch")
        assert _body(getattr(tmod, name)) == want, name


@pytest.mark.parametrize("epochs", [3, "3", "auto"])
def test_resolve_epochs_matches_jax(epochs):
    from genomics_lm_tpu.training import optim as jax_optim
    from genomics_lm_torch.training import optim

    for extra in ({}, {"tokens_per_param": 4.0, "epochs_max": 7}, {"epochs_min": 9}):
        cfg = dict(extra, epochs=epochs)
        assert optim.resolve_epochs(cfg, 123_456, 50_000) == \
            jax_optim.resolve_epochs(cfg, 123_456, 50_000)
