"""The port's timing and run tools against the JAX package's scripts, on the
CPU.

- ``training/profile_train.py`` at a tiny size writes ``summary.txt`` with
  ``scripts/profile_train.py``'s labels in its order and a profiler trace
  under ``--out_dir``; its batch is byte-equal to the one the script hands
  its step (recorded by a stand-in step, so JAX compiles nothing).
- ``training/benchmark_training_speed.py`` builds the script's job list for
  ``--candidates`` and for a ``--matrix`` YAML (each spec plus the probe's
  device), picks the same ``selected_policy`` from the same results and
  classifies the same probe failures alike (PyTorch's CUDA OOM text ->
  ``oom``, another failure -> ``failed``, a timeout -> ``timeout``); the
  probes are recorded by patching ``run_candidate_subprocess`` (or
  ``subprocess.run``) in both. One real probe subprocess on the CPU at a
  tiny size returns ``ok`` with the script probe's keys.
- ``training/make_run_id.py`` prints the script's id, explicit and derived.
- ``utils/hardware_monitor.py --iterations 1`` prints the script's fields;
  with ``--device`` and no card it raises (JAX's CPU backend leaves the
  field out).
- ``training/runtime.py::device_memory_stats`` with no device means the
  card: it raises here; on the CPU it is empty.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess

import numpy as np
import pytest

import scripts.benchmark_training_speed as jax_speed
from genomics_lm_torch.training import benchmark_training_speed as speed

TINY = ["--n_layer", "1", "--n_head", "2", "--n_embd", "16", "--block_size", "16",
        "--batch_size", "2", "--grad_accum", "2", "--steps", "2"]
OOM_TEXT = ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has "
            "a total capacity of 79.19 GiB of which 1.06 GiB is free.")
OTHER_TEXT = "ValueError: n_embd must be divisible by n_head"


def test_profile_train_summary_trace_and_batch(tmp_path, monkeypatch, capsys):
    import jax
    import jax.numpy as jnp

    import genomics_lm_tpu.training.train_step as jax_train_step
    from genomics_lm_torch.training.profile_train import main as port
    from scripts.profile_train import main as jax_main

    seen = []

    def recording_step(cfg, loss_cfg, tx):
        def step(params, opt_state, batch, key, scale):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return params, opt_state, {"total_loss_sum": jnp.float32(0.0)}
        return step

    monkeypatch.setattr(jax_train_step, "make_train_step", recording_step)
    monkeypatch.setattr(jax.profiler, "trace", lambda _: contextlib.nullcontext())
    assert jax_main([*TINY, "--out_dir", str(tmp_path / "jax")]) == 0
    assert port([*TINY, "--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    capsys.readouterr()
    want = (tmp_path / "jax" / "summary.txt").read_text().splitlines()
    got = (tmp_path / "port" / "summary.txt").read_text().splitlines()
    assert [line.split(":")[0] for line in got] == [line.split(":")[0] for line in want]
    assert got[:3] == want[:3]
    assert list((tmp_path / "port").glob("*.pt.trace.json"))

    from genomics_lm_torch.training.profile_train import make_batch

    x, y = make_batch(2, 2, 16)
    assert len(seen) == 3  # the warm step and two traced ones
    assert x.dtype == seen[0]["x"].dtype and x.tobytes() == seen[0]["x"].tobytes()
    assert y.tobytes() == seen[0]["y"].tobytes()


def recorded_jobs(monkeypatch, module, argv):
    specs = []

    def record(spec, timeout=900.0):
        specs.append(json.loads(json.dumps(spec)))
        return {"ok": False, "error": "failed"}

    monkeypatch.setattr(module, "run_candidate_subprocess", record)
    assert module.main(argv) == 0
    return specs


def test_speed_sweep_jobs_equal_the_script(tmp_path, monkeypatch, capsys):
    base = tmp_path / "base.yaml"
    base.write_text("n_layer: 2\nn_embd: 64\nblock_size: 64\n")
    matrix = tmp_path / "matrix.yaml"
    matrix.write_text("base:\n  batch_size: 4\n  dropout: 0.0\noverrides:\n"
                      "  small: {grad_accum_steps: 2}\n  wide: {batch_size: 16, n_head: 4}\n"
                      "  none:\n")
    for flags in (["--candidates", "4x32,16x2"], ["--matrix", str(matrix), "--config", str(base)],
                  []):
        out = ["--out", str(tmp_path / "speed.json"), "--measure_steps", "3", *flags]
        want = recorded_jobs(monkeypatch, jax_speed, out)
        got = recorded_jobs(monkeypatch, speed, out + ["--device", "cpu"])
        assert [s.pop("device") for s in got] == ["cpu"] * len(want)
        assert got == want and want
    capsys.readouterr()


def test_speed_sweep_selects_like_the_script(tmp_path, monkeypatch, capsys):
    results = iter([])

    def scripted(spec, timeout=900.0):
        return dict(next(results))

    rows = [{"ok": True, "nonpad_tokens_per_sec": 10.0}, {"ok": False, "error": "oom"},
            {"ok": True, "nonpad_tokens_per_sec": 30.0}, {"ok": True, "nonpad_tokens_per_sec": 20.0}]
    reports = []
    for module, extra in ((jax_speed, []), (speed, ["--device", "cpu"])):
        results = iter(rows)
        monkeypatch.setattr(module, "run_candidate_subprocess", scripted)
        dest = tmp_path / f"{module.__name__}.json"
        assert module.main(["--candidates", "4x32,8x16,16x8,32x4", "--out", str(dest),
                            *extra]) == 0
        reports.append(json.loads(dest.read_text()))
    assert reports[1] == reports[0] and reports[1]["selected_policy"]["name"] == "b16x8"
    assert speed.select_policy([rows[1]]) is None
    capsys.readouterr()


def test_speed_probe_failures_classify_like_the_script(monkeypatch):
    def fake_run(stderr, timeout=False):
        def run(cmd, capture_output, text, timeout):
            if timeout_flag:
                raise subprocess.TimeoutExpired(cmd, timeout)
            return subprocess.CompletedProcess(cmd, 1, stdout="", stderr=stderr)
        timeout_flag = timeout
        return run

    for stderr, timeout, want in ((OOM_TEXT, False, "oom"), (OTHER_TEXT, False, "failed"),
                                  ("", True, "timeout")):
        got = []
        for module in (jax_speed, speed):
            monkeypatch.setattr(module.subprocess, "run", fake_run(stderr, timeout))
            got.append(module.run_candidate_subprocess({"model": {}}))
        assert got[1] == got[0] and got[1]["error"] == want


def test_speed_probe_runs_on_the_cpu(capsys):
    model = {"vocab_size": 68, "block_size": 16, "n_layer": 1, "n_head": 2, "n_embd": 16,
             "dropout": 0.1, "attention_impl": "xla", "compute_dtype": "float32"}
    result = speed.run_candidate_subprocess({"model": model, "batch_size": 2, "grad_accum": 2,
                                             "measure_steps": 1, "device": "cpu"}, timeout=300)
    assert result.get("ok") is True, result
    source = jax_speed._PROBE_SOURCE
    keys = re.findall(r'^\s*"(\w+)":', source[source.index("print(json.dumps({"):], re.M)
    assert list(result) == keys
    assert result["device_memory"] == {} and result["nonpad_tokens_per_sec"] > 0


def test_make_run_id_prints_the_script_id(tmp_path, capsys):
    from genomics_lm_torch.training.make_run_id import main as port
    from scripts.make_run_id import main as jax_main

    named = tmp_path / "stage2_named.yaml"
    named.write_text("run_id: '  my-run  '\nn_layer: 2\n")
    derived = tmp_path / "stage3_auto.yaml"
    derived.write_text("n_layer: 4\nn_head: 2\nn_embd: 64\nepochs: 3\n")
    for path in (named, derived):
        printed = []
        for main in (jax_main, port):
            assert main([str(path)]) == 0
            printed.append(capsys.readouterr().out)
        assert printed[1] == printed[0]
    assert printed[1].strip().endswith("_stage3_4L2H_d64_e3")


def test_hardware_monitor_fields_and_device(tmp_path, capsys):
    from genomics_lm_torch.utils.hardware_monitor import main as port
    from scripts.hardware_monitor import main as jax_main

    (tmp_path / "scores").mkdir()
    (tmp_path / "scores" / "curves.csv").write_text("epoch,train,val\n1,2,3\n2,2,3\n")
    fields = []
    for main in (jax_main, port):
        assert main(["--run_dir", str(tmp_path), "--iterations", "1", "--interval", "0"]) == 0
        line = capsys.readouterr().out.strip()
        fields.append(re.sub(r"[0-9.]+GB", "GB", line))
    assert fields[1] == fields[0] and fields[1].endswith("curve_rows=3")
    assert jax_main(["--iterations", "1", "--interval", "0", "--device"]) == 0
    assert "hbm=" not in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # no card here
        port(["--iterations", "1", "--interval", "0", "--device"])


def test_device_memory_stats_means_the_card():
    from genomics_lm_torch.training.runtime import device_memory_stats

    assert device_memory_stats("cpu") == {}
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # no card here
        device_memory_stats()
