"""PyTorch port of the Markov baselines, the paired bootstrap and the
``evaluate_test`` CLI against the JAX package.

``evals/markov.py`` and ``evals/significance.py`` are float64 numpy on both
sides, running the same operations in the same order: their outputs are
held EXACTLY equal (tolerance 0), dense tables and the sparse path above
256 tokens alike. The CLI runs on one tiny run (2 layers, d 32, block 64,
trained one epoch by the port on a prepared demo corpus) through both
packages' ``evaluate_test``: the report's keys and flags are equal, the
baselines exact, and the model NLL, per-window ablation and margins agree
within 1e-5 (float32 forwards whose sums differ only in order).
"""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest
import torch

from genomics_lm_tpu.evals import markov as jax_markov
from genomics_lm_tpu.evals import significance as jax_significance
from genomics_lm_torch.data.demo_corpus import main as demo_corpus
from genomics_lm_torch.data.pipeline import prepare_dataset
from genomics_lm_torch.evals import evaluate_test, markov, significance
from genomics_lm_torch.evals.provenance import EvaluationProvenanceError
from genomics_lm_torch.training.loop import run_training

RTOL = 1e-5  # float32 model NLL on both sides; only the order of the sums differs
BLOCK = 64


def markov_split(rng, n: int, T: int, V: int, sep: int = 3):
    """Rows of a sparse chain with <SEP> resets, pad tails and pad rows."""
    succ = rng.integers(4, V, (V, 3))
    X = np.zeros((n, T), np.int64)
    X[:, 0] = rng.integers(4, V, n)
    for t in range(1, T):
        X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
    X[:, 7::13] = sep
    Y = np.roll(X, -1, axis=1)
    Y[:, -1] = 0
    Y[: n // 4, -9:] = 0
    Y[-1] = 0  # a row with no evaluable target
    return X, Y


@pytest.mark.parametrize("V", [68, 300], ids=["dense", "sparse"])
@pytest.mark.parametrize("reset", [frozenset(), frozenset({3})], ids=["no_reset", "sep_reset"])
def test_baselines_equal_jax(V, reset):
    rng = np.random.default_rng(V)
    train = markov_split(rng, 40, 48, V)
    test = markov_split(rng, 17, 48, V)
    counts = markov.fit_baselines(*train, V, 0.02, reset_token_ids=reset)
    want_counts = jax_markov.fit_baselines(*train, V, 0.02, reset_token_ids=reset)
    np.testing.assert_array_equal(counts[0], want_counts[0])
    for got, want in zip(counts[1:], want_counts[1:]):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    results = markov.evaluate_baselines(*test, counts, V, 0.02, reset_token_ids=reset)
    assert results == jax_markov.evaluate_baselines(*test, want_counts, V, 0.02,
                                                    reset_token_ids=reset)
    rows, tokens = markov.per_row_baseline_nll(*test, counts, V, 0.02, reset_token_ids=reset)
    want_rows, want_tokens = jax_markov.per_row_baseline_nll(*test, want_counts, V, 0.02,
                                                             reset_token_ids=reset)
    np.testing.assert_array_equal(tokens, want_tokens)
    assert tokens[-1] == 0 and rows.keys() == want_rows.keys()
    for name in markov.MODEL_NAMES:
        np.testing.assert_array_equal(rows[name], want_rows[name])
    with pytest.raises(ValueError, match="alpha"):
        markov.fit_baselines(*train, V, 0.0)


def test_bootstrap_equals_jax():
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 60, 50)
    tokens[3] = 0
    model = rng.random(50) * tokens * 2.0
    base = {"Unigram": model + rng.normal(0.3, 1.0, 50) * tokens,
            "Bigram": model + rng.normal(0.0, 1.0, 50) * tokens}
    for seed, n_boot, ci in ((0, 500, 0.95), (7, 200, 0.9)):
        got = significance.paired_bootstrap_margins(model, tokens, base, n_boot=n_boot,
                                                    seed=seed, ci=ci)
        assert got == jax_significance.paired_bootstrap_margins(model, tokens, base,
                                                                n_boot=n_boot, seed=seed, ci=ci)
        assert got["Unigram"]["n_rows"] == 49
    with pytest.raises(ValueError, match="at least 2"):
        significance.paired_bootstrap_margins(model[:1], tokens[:1], {"U": model[:1]})


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A prepared demo-corpus dataset (block 64) and a 2-layer d32 run
    trained on it for one epoch by the port's trainer."""
    root = tmp_path_factory.mktemp("evaluate_test")
    demo_corpus(["--out", str(root / "records.tsv"), "--genes", "60", "--seed", "2",
                 "--min_codons", "30", "--max_codons", "100"])
    with (root / "records.tsv").open() as f:
        records = list(csv.DictReader(f, delimiter="\t"))
    data = root / "dataset"
    prepare_dataset(records, data, block_size=BLOCK, split_seed=2, skip_homology=True)
    cfg = dict(train_npz=str(data / f"train_bs{BLOCK}.npz"),
               val_npz=str(data / f"val_bs{BLOCK}.npz"), block_size=BLOCK, n_layer=2,
               n_head=2, n_embd=32, dropout=0.0, batch_size=8, grad_accum_steps=1, lr=3e-3,
               warmup_steps=2, epochs=1, seed=3, early_stop_patience=0, run_id="tiny")
    torch.manual_seed(0)
    run_training(cfg, run_root=str(root / "runs"), device="cpu", progress_every=0)
    return {"run": root / "runs" / "tiny", "data": data}


def run_both(tiny_run, tmp_path, *extra):
    from scripts.evaluate_test import main as jax_main

    data = tiny_run["data"]
    args = [str(tiny_run["run"]), "--test_npz", str(data / f"test_bs{BLOCK}.npz"), *extra]
    jax_main(args + ["--out", str(tmp_path / "jax.json")])
    assert evaluate_test.main(args + ["--out", str(tmp_path / "port.json"),
                                      "--device", "cpu"]) == 0
    return (json.loads((tmp_path / "port.json").read_text()),
            json.loads((tmp_path / "jax.json").read_text()))


def assert_model_block(got, want):
    assert got.keys() == want.keys()
    assert got["tokens"] == want["tokens"] and got["attention_window"] == want["attention_window"]
    for key in ("nll", "perplexity", "bits_per_codon"):
        assert got[key] == pytest.approx(want[key], rel=RTOL), key


def test_evaluate_test_cli_matches_jax(tiny_run, tmp_path, capsys):
    data = tiny_run["data"]
    got, want = run_both(tiny_run, tmp_path, "--train_npz", str(data / f"train_bs{BLOCK}.npz"),
                         "--bootstrap", "300", "--bootstrap_seed", "5", "--context_ablation",
                         "--dataset_manifest", str(data / "manifest.json"))
    printed = capsys.readouterr().out
    assert got.keys() == want.keys() == {
        "run_id", "test_npz", "model", "baselines", "baseline_tokens", "best_simple_model",
        "beats_best_simple", "margins", "margins_protocol", "context_ablation", "provenance"}
    assert_model_block(got["model"], want["model"])
    for key in ("run_id", "test_npz", "baselines", "baseline_tokens", "best_simple_model",
                "beats_best_simple", "margins_protocol", "provenance"):
        assert got[key] == want[key], key  # baselines exact: float64 numpy on both sides
    assert got["provenance"]["checkpoint_dataset"]["status"] == "checkpoint_manifest_verified"
    assert got["margins"].keys() == want["margins"].keys() == set(markov.MODEL_NAMES)
    for name, m in want["margins"].items():
        assert got["margins"][name].keys() == m.keys()
        for key in ("margin_nats", "ci_low", "ci_high"):
            assert got["margins"][name][key] == pytest.approx(m[key], abs=RTOL), (name, key)
        for key in ("excludes_zero", "n_boot", "n_rows", "ci_level"):
            assert got["margins"][name][key] == m[key], (name, key)
    assert got["context_ablation"].keys() == want["context_ablation"].keys()
    for window, block in want["context_ablation"].items():
        assert_model_block(got["context_ablation"][window], block)
    assert "best simple model:" in printed and "[evaluate_test] seconds" in printed
    assert printed.count("margin vs ") == 8  # both CLIs print each of the four


def test_evaluate_test_model_only_and_default_path(tiny_run, tmp_path):
    got, want = run_both(tiny_run, tmp_path)
    assert got.keys() == want.keys() == {"run_id", "test_npz", "model"}
    assert_model_block(got["model"], want["model"])
    from genomics_lm_torch.evals.evaluate_test import parser

    args = parser().parse_args([str(tiny_run["run"]), "--test_npz", "x.npz"])
    assert args.device is None  # the card unless the caller names another


def test_require_scientific_valid_fails_closed_in_both(tiny_run, tmp_path):
    from genomics_lm_tpu.evals.provenance import EvaluationProvenanceError as JaxError
    from scripts.evaluate_test import main as jax_main

    data = tiny_run["data"]
    base = [str(tiny_run["run"]), "--test_npz", str(data / f"test_bs{BLOCK}.npz"),
            "--require_scientific_valid"]
    for args in (base, base + ["--dataset_manifest", str(data / "manifest.json")]):
        with pytest.raises(JaxError) as want:
            jax_main(args + ["--out", str(tmp_path / "jax.json")])
        with pytest.raises(EvaluationProvenanceError) as got:
            evaluate_test.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
        assert str(got.value) == str(want.value)
    assert not (tmp_path / "port.json").exists()
