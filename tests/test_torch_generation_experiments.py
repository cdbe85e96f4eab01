"""The port's generation experiments against their JAX scripts.

One module-scoped pair of tiny runs (2 layers, d 64, block 64): ``base`` a
seeded init in the trainers' checkpoint format (the JAX tree layout both
packages read), ``tuned`` one epoch of the port's trainer from it on a
prepared demo corpus; one seeded critic (attention-pooled, stability a
2-class head) and an EBM over its latents, likewise. Each CLI runs against its script on the same arguments:

- ``run_guidance_ablation``, ``run_ablation_sweep``,
  ``structured_prefix_experiment`` and ``benchmark_hybrid_critic`` with the
  critic (and the EBM): reports, CSV rows and Markdown equal, but for the
  wall-time fields;
- ``perturbation_motifs`` and ``utr_generation`` (the scripts'
  ``test_perturbation_motifs`` and ``test_utr_generation``): reports equal;
- ``compare_generators``: the commands it builds for the port's design loop
  (run here in process) on both runs against the script's JAX loop,
  summaries and deltas equal but for the elapsed seconds.

"Equal" is the constrained-generation suite's standard: every draw comes
from one numpy generator, the port's generators match JAX's token for
token, and floats (stop masses, critic scores, energies) agree within
``TOL`` of the larger, since the two packages' float32 forwards sum in a
different order.
"""

from __future__ import annotations

import csv
import json
import subprocess
import types

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import protein as jpm
from genomics_lm_torch.data.demo_corpus import main as demo_corpus
from genomics_lm_torch.data.pipeline import prepare_dataset
from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.models.protein import (
    MultiTaskProteinCritic,
    ProteinClassifierConfig,
    ProteinLatentEBM,
    init_weights,
)
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training.checkpoints import save_checkpoint
from genomics_lm_torch.training.loop import run_training
from genomics_lm_torch.utils.weights import params_to_jax, protein_params_to_jax

TOL = 1e-5  # float32 forwards whose sums differ only in order
BLOCK = 64
MODEL = dict(vocab_size=68, block_size=BLOCK, n_layer=2, n_head=2, n_embd=64, dropout=0.0,
             sep_id=3)
WALL_KEYS = {"wall_sec", "samples_per_sec", "elapsed_sec"}


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax():
    """The JAX scripts' forwards compiled whole for the module: the same
    functions, one compile per shape instead of one eager dispatch per
    primitive at every call (the guided generators score a new length every
    step)."""
    from genomics_lm_tpu.protein import critic_scoring as jcs

    with pytest.MonkeyPatch.context() as mp:
        for module in (jcs, jpm):
            for name in ("multitask_forward", "extract_latent"):
                mp.setattr(module, name, jax.jit(getattr(module, name), static_argnums=1))
        mp.setattr(jpm, "ebm_energy", jax.jit(jpm.ebm_energy))
        yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen_experiments")
    demo_corpus(["--out", str(root / "records.tsv"), "--genes", "60", "--seed", "2",
                 "--min_codons", "30", "--max_codons", "100"])
    with (root / "records.tsv").open() as f:
        records = list(csv.DictReader(f, delimiter="\t"))
    data = root / "dataset"
    prepare_dataset(records, data, block_size=BLOCK, split_seed=2, skip_homology=True)
    base = root / "runs" / "base"
    (base / "checkpoints").mkdir(parents=True)
    torch.manual_seed(3)
    params = params_to_jax(CodonGPT(CodonGPTConfig(**MODEL)), CodonGPTConfig(**MODEL))
    # the init's tied embedding makes the model repeat its last codon; a tenth
    # of it gives a spread next-codon law, so the generators meet stop codons
    params["tok_emb"] = params["tok_emb"] * np.float32(0.1)
    save_checkpoint({"model": params, "cfg": dict(MODEL)}, base / "checkpoints" / "best.npz")
    write_itos(base / "itos.txt")
    meta = run_training(dict(MODEL, train_npz=str(data / f"train_bs{BLOCK}.npz"),
                             val_npz=str(data / f"val_bs{BLOCK}.npz"), batch_size=8,
                             grad_accum_steps=1, lr=3e-3, min_lr=3e-4, warmup_steps=1,
                             epochs=1, seed=0, early_stop_patience=0, run_id="tuned",
                             attention_impl="xla", compute_dtype="float32"),
                        transfer_from=str(base / "checkpoints" / "best.npz"),
                        run_root=root / "runs", device="cpu")
    assert meta["status"] == "completed"

    dims = {"family": 3, "function": 2, "stability": 2}
    cfg = dict(n_layer=1, n_head=2, n_embd=16, block_size=128, pooling="attention")
    critic = init_weights(MultiTaskProteinCritic(ProteinClassifierConfig(
        vocab_size=28, dropout=0.0, **cfg), dims), seed=7)
    ebm = init_weights(ProteinLatentEBM(n_embd=16, hidden_dim=8), seed=8)
    save_checkpoint({"model": protein_params_to_jax(critic), "cfg": cfg, "task_dims": dims},
                    root / "critic.npz")
    save_checkpoint({"model": protein_params_to_jax(ebm)}, root / "ebm.npz")
    return {"root": root, "base": base, "tuned": root / "runs" / "tuned", "data": data,
            "critic": str(root / "critic.npz"), "ebm": str(root / "ebm.npz")}


def assert_close(got, want, what):
    """Equal, with floats (and float cells of CSV rows) within TOL of the larger."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for key in want:
            assert_close(got[key], want[key], f"{what}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{what}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(float(got) - want) <= TOL * max(1.0, abs(want)), (what, got, want)
    elif isinstance(want, str) and _is_float(want) and not want.isdigit():
        assert_close(float(got), float(want), what)
    else:
        assert got == want, (what, got, want)


def _is_float(text: str) -> bool:
    try:
        float(text)
    except ValueError:
        return False
    return True


def without_wall(report):
    if isinstance(report, list):
        return [without_wall(r) for r in report]
    return {k: v for k, v in report.items() if k not in WALL_KEYS}


def run_both(name, argv, tmp_path, capsys, out_flag="--out"):
    """Run the script and the port's CLI (``--device cpu``), each writing to
    its own ``out_flag`` path under ``tmp_path``; return both paths."""
    import importlib

    script = importlib.import_module(f"scripts.{name[0]}")
    port = importlib.import_module(f"genomics_lm_torch.{name[1]}")
    paths = {}
    for side, main, extra in (("jax", script.main, []), ("port", port.main, ["--device", "cpu"])):
        paths[side] = tmp_path / side
        assert main(argv + [out_flag, str(paths[side]), *extra]) == 0
    capsys.readouterr()
    return paths


def test_guidance_ablation_matches_the_script(runs, tmp_path, capsys):
    paths = run_both(("run_guidance_ablation", "generation.run_guidance_ablation"),
                     [str(runs["base"]), "--critic_ckpt", runs["critic"], "--n_samples", "2",
                      "--target_codons", "3", "--hard_cap", "12", "--seed", "1"],
                     tmp_path, capsys)
    got, want = (json.loads(paths[s].read_text()) for s in ("port", "jax"))
    assert_close(got, want, "guidance_ablation")
    assert set(got) == {"unguided", "termination_bias", "critic_guided"}
    assert any(v["terminal_stop_rate"] > 0 for v in got.values())


def test_ablation_sweep_matches_the_script(runs, tmp_path, capsys):
    paths = run_both(("run_ablation_sweep", "generation.run_ablation_sweep"),
                     [str(runs["tuned"]), "--critic_ckpt", runs["critic"], "--n_samples", "2",
                      "--target_codons", "3", "--hard_cap", "12", "--seed", "2"],
                     tmp_path, capsys)
    got, want = (json.loads(paths[s].read_text()) for s in ("port", "jax"))
    assert_close(without_wall(got), without_wall(want), "ablation_sweep")
    assert len(got) == 4 and all(r["wall_sec"] >= 0 for r in got)


def test_structured_prefix_matches_the_script(runs, tmp_path, capsys):
    paths = run_both(("structured_prefix_experiment",
                      "generation.structured_prefix_experiment"),
                     [str(runs["base"]), "--critic_ckpt", runs["critic"], "--n_per_prefix", "2",
                      "--target_codons", "3", "--hard_cap", "12", "--seed", "3"],
                     tmp_path, capsys, out_flag="--out_dir")
    out = {}
    for side, path in paths.items():
        with (path / "structured_prefix_candidates.csv").open() as f:
            out[side] = {"rows": list(csv.DictReader(f)),
                         "report": (path / "structured_prefix_report.md").read_text()}
    assert_close(out["port"]["rows"], out["jax"]["rows"], "candidates")
    got, want = (out[s]["report"].splitlines() for s in ("port", "jax"))
    assert len(got) == len(want)
    for g, w in zip(got, want):  # the best critic score, printed to 4 places
        if g.startswith("- best critic score"):
            assert_close(float(g.split()[4]), float(w.split()[4]), g)
        else:
            assert g == w
    assert len(out["port"]["rows"]) == 6 and "critic_score" in out["port"]["rows"][0]


def test_hybrid_critic_matches_the_script(runs, tmp_path, capsys):
    paths = run_both(("benchmark_hybrid_critic", "generation.benchmark_hybrid_critic"),
                     [str(runs["tuned"]), "--critic_ckpt", runs["critic"], "--ebm_ckpt",
                      runs["ebm"], "--alphas", "0,1.0", "--n_samples", "2",
                      "--target_codons", "3", "--hard_cap", "12", "--seed", "4"],
                     tmp_path, capsys)
    got, want = (json.loads(paths[s].read_text()) for s in ("port", "jax"))
    assert_close(without_wall(got), without_wall(want), "hybrid_critic")
    assert [r["alpha"] for r in got] == [0.0, 1.0]
    assert all(r["mean_ebm_energy"] is not None and r["samples_per_sec"] > 0 for r in got)


def test_perturbation_and_utr_match_the_scripts(runs, tmp_path, capsys):
    for script, port, argv in (
            ("test_perturbation_motifs", "evals.perturbation_motifs",
             ["--npz", str(runs["data"] / f"val_bs{BLOCK}.npz"), "--n_prefixes", "4",
              "--prefix_codons", "5", "--seed", "5"]),
            ("test_utr_generation", "evals.utr_generation",
             ["--n_samples", "3", "--prefix_codons", "4", "--utr_codons", "5", "--seed", "6"])):
        paths = run_both((script, port), [str(runs["tuned"]), *argv], tmp_path / script, capsys)
        got, want = (json.loads(paths[s].read_text()) for s in ("port", "jax"))
        assert_close(got, want, script)
        assert got.get("n_prefixes", got.get("n_samples")) > 0


def test_compare_generators_matches_the_script(runs, tmp_path, capsys, monkeypatch):
    """Each side's design loops run in this process, from the command its CLI
    builds (the interpreter and the script path or ``-m`` module dropped):
    that keeps two packages' start-ups out of the suite's time. The port's
    command runs as a real subprocess on the card (``chip_smoke.py``'s
    ``[gen_experiments]``)."""
    from genomics_lm_torch.generation import compare_generators as port
    from genomics_lm_torch.generation import generative_design_loop as port_loop
    from scripts import compare_generators as script
    from scripts import generative_design_loop as jax_loop

    def in_process(cmd, check, env=None):
        assert check
        if cmd[1] == "-m":
            assert cmd[2] == "genomics_lm_torch.generation.generative_design_loop"
            assert env["PYTHONPATH"].split(":")[0] == str(port.REPO_ROOT)
            assert port_loop.main(cmd[3:]) == 0
        else:
            assert cmd[1].endswith("scripts/generative_design_loop.py")
            assert jax_loop.main(cmd[2:]) == 0
        return subprocess.CompletedProcess(cmd, 0)

    for module in (script, port):
        monkeypatch.setattr(module, "subprocess", types.SimpleNamespace(run=in_process))
    argv = ["--baseline_dir", str(runs["base"]), "--finetuned_dir", str(runs["tuned"]),
            "--critic_ckpt", runs["critic"], "--n_sequences", "2", "--target_codons", "3",
            "--seed", "7"]
    out = {}
    for side, main, extra in (("jax", script.main, []), ("port", port.main, ["--device", "cpu"])):
        assert main(argv + ["--out_dir", str(tmp_path / side), *extra]) == 0
        report = json.loads((tmp_path / side / "comparison.json").read_text())
        out[side] = {key: without_wall(report[key]) for key in report}
    capsys.readouterr()
    assert_close(out["port"], out["jax"], "comparison")
    assert out["port"]["baseline"]["requested"] == 2
    assert "mean_stability_prob" in out["port"]["deltas"]
