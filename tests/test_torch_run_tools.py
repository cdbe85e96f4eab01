"""The port's run tools against the JAX package's scripts, on the CPU.

One tiny run trained by JAX's trainer (2 epochs with ``save_epochs``, on a
dataset prepared from the demo corpus) is read by both packages (the port
loads a JAX run as its own):

- ``evals/eval_epoch_sweep.py`` and ``evals/compare_checkpoints.py`` against
  ``scripts/eval_epoch_sweep.py`` and ``scripts/compare_checkpoints.py``:
  the same rows, perplexity and NLL within 1e-5, token counts exact;
- ``evals/sanity_kpis.py`` against ``scripts/sanity_kpis.py``: the same
  checks (the perplexity within 1e-5) and verdict;
- ``evals/compare_runs.py`` against ``scripts/compare_runs.py``: the same
  summary rows, ``summary.md`` and ``_summary/summary.csv``;
- ``data/freeze_corrected_datasets.py`` and ``data/verify_dataset_freeze.py``
  against their scripts: the same ``freeze.json`` (its roots aside), freeze
  id, copied manifests and read-only modes; each verifier accepts the
  other's release and both refuse a tampered one alike;
- ``training/training_preflight.py`` passes, as ``scripts/training_preflight.py``
  does, with the same checks.
"""

from __future__ import annotations

import csv
import json
import os
import stat

import numpy as np
import pytest

from genomics_lm_tpu.training import loop as jax_loop
from genomics_lm_torch.data import pipeline
from genomics_lm_torch.data.demo_corpus import main as demo_corpus

RTOL = 1e-5


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tools")
    path = tmp / "records.tsv"
    demo_corpus(["--out", str(path), "--genes", "60", "--seed", "3", "--min_codons", "20",
                 "--max_codons", "90"])
    with path.open() as f:
        records = [dict(r) for r in csv.DictReader(f, delimiter="\t")]
    datasets = {}
    for block in (32, 64):
        d = tmp / f"ds{block}"
        pipeline.prepare_dataset([dict(r) for r in records], d, block_size=block,
                                 group_by="genome", split_seed=7, skip_homology=True)
        datasets[block] = d
    d = datasets[64]
    cfg = dict(train_npz=str(d / "train_bs64.npz"), val_npz=str(d / "val_bs64.npz"),
               block_size=64, n_layer=1, n_head=2, n_embd=16, dropout=0.0, batch_size=4,
               grad_accum_steps=1, lr=3e-2, min_lr=1e-3, warmup_steps=1, epochs=2, seed=0,
               run_id="tiny", early_stop_patience=0, save_epochs=True)
    meta = jax_loop.run_training(cfg, run_root=str(tmp / "runs"))
    assert meta["status"] == "completed"
    return {"tmp": tmp, "run": tmp / "runs" / "tiny", "runs": tmp / "runs",
            "val": d / "val_bs64.npz", "datasets": datasets}


def test_epoch_sweep_matches_jax(run, capsys):
    from scripts.eval_epoch_sweep import main as jax_sweep
    from genomics_lm_torch.evals.eval_epoch_sweep import main as sweep

    out = {}
    for side, fn, extra in (("jax", jax_sweep, []), ("port", sweep, ["--device", "cpu"])):
        dest = run["tmp"] / f"sweep_{side}.json"
        assert fn([str(run["run"]), "--npz", str(run["val"]), "--batch_size", "8",
                   "--out", str(dest), *extra]) == 0
        out[side] = json.loads(dest.read_text())
    assert [r["checkpoint"] for r in out["port"]] == ["epoch_1.npz", "epoch_2.npz"]
    assert len(out["port"]) == len(out["jax"])
    for got, want in zip(out["port"], out["jax"]):
        assert (got["checkpoint"], got["epoch"], got["tokens"]) == (
            want["checkpoint"], want["epoch"], want["tokens"])
        for key in ("nll", "perplexity"):
            assert rel(got[key], want[key]) <= RTOL, (key, got, want)
    assert capsys.readouterr().out.count("[sweep] epoch_2.npz") == 2


def test_compare_checkpoints_matches_jax(run, capsys):
    from scripts.compare_checkpoints import main as jax_compare
    from genomics_lm_torch.evals.compare_checkpoints import main as compare

    ckpts = [str(run["run"] / "checkpoints" / f"epoch_{e}.npz") for e in (1, 2)]
    rows = {}
    for side, fn, extra in (("jax", jax_compare, []), ("port", compare, ["--device", "cpu"])):
        capsys.readouterr()
        assert fn([*ckpts, "--npz", str(run["val"]), "--batch_size", "8", *extra]) == 0
        text = capsys.readouterr().out
        rows[side] = json.loads(text[: text.index("[compare]")])
    assert [(r["checkpoint"], r["epoch"], r["spec"]) for r in rows["port"]] == [
        (r["checkpoint"], r["epoch"], r["spec"]) for r in rows["jax"]]
    for got, want in zip(rows["port"], rows["jax"]):
        assert rel(got["nll"], want["nll"]) <= RTOL and rel(got["perplexity"],
                                                             want["perplexity"]) <= RTOL


def test_sanity_kpis_match_jax(run, capsys):
    from scripts.sanity_kpis import main as jax_kpis
    from genomics_lm_torch.evals.sanity_kpis import main as kpis

    reports = {}
    for side, fn, extra in (("jax", jax_kpis, []), ("port", kpis, ["--device", "cpu"])):
        dest = run["tmp"] / f"kpis_{side}.json"
        rc = fn([str(run["run"]), "--val_npz", str(run["val"]), "--out", str(dest), *extra])
        reports[side] = (rc, json.loads(dest.read_text()))
    (rc, got), (jrc, want) = reports["port"], reports["jax"]
    assert rc == jrc == 0 and got["passed"] is want["passed"] is True
    assert set(got["checks"]) == set(want["checks"])
    for key, value in want["checks"].items():
        if isinstance(value, float):
            assert rel(got["checks"][key], value) <= RTOL, key
        else:
            assert got["checks"][key] == value, key
    assert got["checks"]["curve_epochs"] == 2


def test_compare_runs_matches_jax(run, capsys, tmp_path):
    import shutil

    from scripts.compare_runs import main as jax_compare_runs
    from genomics_lm_torch.evals.compare_runs import main as compare_runs

    out = {}
    for side, fn in (("jax", jax_compare_runs), ("port", compare_runs)):
        root = tmp_path / side
        shutil.copytree(run["runs"], root)
        for p in root.rglob("summary*"):
            p.unlink()
        capsys.readouterr()
        assert fn(["--root", str(root)]) == 0
        lines = capsys.readouterr().out.splitlines()
        first = next(i for i, line in enumerate(lines) if line in ("[", "[]"))
        last = next(i for i, line in enumerate(lines) if line.startswith("[compare]"))
        rows = json.loads("\n".join(lines[first:last]))
        out[side] = (rows, (root / "summary.md").read_text(),
                     (root / "_summary" / "summary.csv").read_text())
    assert out["port"] == out["jax"]
    assert out["port"][0][0]["run_id"] == "tiny" and out["port"][0][0]["complete"] is True


def release_tree(release_dir) -> dict:
    """Every file of a release: its relative path → (mode bits, bytes)."""
    return {str(p.relative_to(release_dir)): (stat.S_IMODE(p.stat().st_mode), p.read_bytes())
            for p in sorted(release_dir.rglob("*")) if p.is_file()
            and p.name != "freeze.json"}


def test_freeze_and_verify_match_jax(run, capsys, tmp_path):
    from scripts.freeze_corrected_datasets import main as jax_freeze
    from scripts.verify_dataset_freeze import main as jax_verify
    from genomics_lm_torch.data.freeze_corrected_datasets import main as freeze
    from genomics_lm_torch.data.verify_dataset_freeze import main as verify

    releases = {}
    for side, fn in (("jax", jax_freeze), ("port", freeze)):
        root = tmp_path / side
        assert fn(["--release", "corrected-v1", "--out_root", str(root), "--read_only",
                   "--protocol", "p32", str(run["datasets"][32]),
                   "--protocol", "p64", str(run["datasets"][64])]) == 0
        releases[side] = root / "corrected-v1"
    text = capsys.readouterr().out
    assert text.count("[freeze] release=corrected-v1 freeze_id=") == 2
    j, t = (json.loads((releases[s] / "freeze.json").read_text()) for s in ("jax", "port"))
    for payload in (j, t):
        for info in payload["protocols"].values():
            info.pop("root")
    assert t == j and len(t["dataset_freeze_id"]) == 64
    assert release_tree(releases["port"]) == release_tree(releases["jax"])
    assert all(mode == 0o444 for mode, _ in release_tree(releases["port"]).values())
    # refusing to overwrite a frozen protocol
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        freeze(["--release", "corrected-v1", "--out_root", str(tmp_path / "port"),
                "--protocol", "p32", str(run["datasets"][32])])
    # each verifier accepts both releases
    capsys.readouterr()
    for fn in (jax_verify, verify):
        for side in ("jax", "port"):
            assert fn([str(releases[side])]) == 0
    assert capsys.readouterr().out.count("[verify] OK release=corrected-v1") == 4
    # a tampered artifact and a drifted freeze id fail both alike
    for side in ("jax", "port"):
        victim = releases[side] / "p64" / "val_bs64.npz"
        os.chmod(victim, 0o644)
        data = bytearray(victim.read_bytes())
        data[len(data) // 2] ^= 0xFF
        victim.write_bytes(bytes(data))
        freeze_json = releases[side] / "freeze.json"
        payload = json.loads(freeze_json.read_text())
        payload["dataset_freeze_id"] = "0" * 64
        freeze_json.write_text(json.dumps(payload))
    results = {}
    for name, fn in (("jax", jax_verify), ("port", verify)):
        capsys.readouterr()
        rcs = [fn([str(releases[side])]) for side in ("jax", "port")]
        results[name] = (rcs, capsys.readouterr().out.replace(str(tmp_path), "<tmp>"))
    assert results["port"] == results["jax"]
    assert results["port"][0] == [1, 1]
    assert results["port"][1].count("[verify] FAIL") == 4


def test_preflight_passes_in_both(tmp_path):
    from scripts.training_preflight import run_preflight as jax_preflight
    from genomics_lm_torch.training.training_preflight import main as preflight
    from genomics_lm_torch.training.training_preflight import run_preflight

    want = jax_preflight(tmp_path / "jax")
    got = run_preflight(tmp_path / "port", device="cpu")
    assert got["checks"] == want["checks"] and got["passed"] is want["passed"] is True
    with np.load(tmp_path / "port" / "train.npz") as a:
        with np.load(tmp_path / "jax" / "train.npz") as b:
            np.testing.assert_array_equal(a["X"], b["X"])
    assert preflight(["--work_dir", str(tmp_path / "cli"), "--device", "cpu"]) == 0
