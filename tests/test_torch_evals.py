"""PyTorch port of run loading and the scoring evals against the JAX package.

Two run directories come from one init: one written by the JAX trainer, one
by the port's. ``evals/playground.py::load_codon_model`` must read each as
JAX's ``load_codon_model`` does (the same logits within 1e-5 of the
largest), with its two fallbacks (the vocabulary size from the embedding
rows, the canonical vocabulary without ``itos.txt``); ``query_next_codon``
and ``score_sequence`` match within 1e-5. On the run's validation split,
``evaluate_perplexity``, ``per_row_model_nll`` and ``context_ablation``
(windows 1, 2, 4 and full, on the einsum path and on the flash path's plain
version) match within 1e-5, and so do the ``score_mutations`` rows, the
sliding window over a CDS longer than the block included. The
``score_mutations`` CLI runs with ``--device cpu``.
"""

from __future__ import annotations

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.evals import mutations as jmut
from genomics_lm_tpu.evals import perplexity as jppl
from genomics_lm_tpu.evals import playground as jplay
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.tokenizers.codon import write_itos
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_tpu.training.loop import run_training as jax_run_training
from genomics_lm_torch.evals import mutations, perplexity, playground
from genomics_lm_torch.models.codon_gpt import forward
from genomics_lm_torch.training.checkpoints import load_checkpoint, save_checkpoint
from genomics_lm_torch.training.loop import run_training

RTOL = 1e-5  # float32 on both sides; only the order of the sums differs
BLOCK = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_rel(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)
    assert err <= rtol, f"{what}: {err} > {rtol}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"jax": run_dir, "port": run_dir}`` trained one epoch each from the
    same init on windows of a sparse bigram chain with <SEP> segments and
    pad tails."""
    root = tmp_path_factory.mktemp("eval_runs")
    rng = np.random.default_rng(0)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", 32), ("val", 12)):
        X = np.zeros((n, BLOCK), np.int32)
        X[:, 0] = rng.integers(4, 68, n)
        for t in range(1, BLOCK):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        X[:, ::11] = 3
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 0
        Y[: n // 3, -6:] = 0
        np.savez(root / f"{name}.npz", X=X, Y=Y)
    write_itos(root / "itos.txt")
    jcfg = JaxConfig(vocab_size=68, block_size=BLOCK, n_layer=2, n_head=2, n_embd=32,
                     dropout=0.0)
    init = root / "init.npz"
    jckpt.save_checkpoint({"model": jax_gpt.init(jax.random.PRNGKey(5), jcfg)}, init)
    cfg = dict(train_npz=str(root / "train.npz"), val_npz=str(root / "val.npz"),
               block_size=BLOCK, n_layer=2, n_head=2, n_embd=32, dropout=0.0,
               batch_size=8, grad_accum_steps=2, lr=1e-3, min_lr=1e-4, warmup_steps=1,
               epochs=1, seed=1337, early_stop_patience=0)
    jax_run_training(dict(cfg, run_id="jax-run"), transfer_from=str(init),
                     run_root=str(root / "runs"))
    run_training(dict(cfg, run_id="port-run"), transfer_from=str(init),
                 run_root=str(root / "runs"), device="cpu", progress_every=0)
    return {"jax": root / "runs" / "jax-run", "port": root / "runs" / "port-run",
            "val": root / "val.npz"}


def jax_model(run_dir, name=None):
    params, cfg, itos, stoi = jplay.load_codon_model(run_dir, name)
    return params, cfg, itos, stoi


# the two trainers from one init: float32 sums in another order, compounded
# over the epoch's steps (the trainer suite holds their logits to the same)
CROSS_RUN_RTOL = 1e-4


@pytest.mark.parametrize("trainer", ["jax", "port"])
def test_load_codon_model_reads_either_trainers_run(runs, trainer):
    params, jcfg, jitos, jstoi = jax_model(runs[trainer])
    model, cfg, itos, stoi = playground.load_codon_model(runs[trainer], device="cpu")
    assert (itos, stoi) == (jitos, jstoi) and cfg.n_layer == jcfg.n_layer
    assert next(model.parameters()).device.type == "cpu"
    x = np.load(runs["val"])["X"][:3]
    want, _ = jax_gpt.forward(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, _ = forward(model, cfg, torch.from_numpy(x).long())
    assert_rel(got.numpy(), want, f"logits of the {trainer} trainer's run")
    assert playground.resolve_checkpoint(runs[trainer]).name == "best.npz"
    assert playground.resolve_checkpoint(runs[trainer], "last.npz").name == "last.npz"
    other, ocfg, _, _ = playground.load_codon_model(
        runs["port" if trainer == "jax" else "jax"], device="cpu")
    with torch.no_grad():
        theirs, _ = forward(other, ocfg, torch.from_numpy(x).long())
    assert_rel(got.numpy(), theirs.numpy(), "the two trainers' runs", CROSS_RUN_RTOL)


def test_load_fallbacks(runs, tmp_path):
    """A legacy run: no ``vocab_size`` in the config, no ``itos.txt``,
    the checkpoint at the run root."""
    payload = load_checkpoint(runs["port"] / "checkpoints" / "best.npz")
    payload["cfg"] = {k: v for k, v in payload["cfg"].items() if k != "vocab_size"}
    save_checkpoint(payload, tmp_path / "last.npz")
    model, cfg, itos, _ = playground.load_codon_model(tmp_path, device="cpu")
    _, jcfg, jitos, _ = jax_model(tmp_path)
    assert cfg.vocab_size == jcfg.vocab_size == 68 and itos == jitos and len(itos) == 68
    with pytest.raises(FileNotFoundError):
        playground.resolve_checkpoint(tmp_path / "missing")
    if not torch.cuda.is_available():  # no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            playground.load_codon_model(tmp_path)


def test_query_next_codon_and_score_sequence_match_jax(runs):
    params, jcfg, itos, stoi = jax_model(runs["port"])
    from genomics_lm_tpu.generation.decode import CachedDecoder as JaxDecoder

    jdec = JaxDecoder(params, jcfg)
    dec, _, _ = playground.make_decoder(runs["port"], device="cpu")
    dna = "ATGGCTAAACCCGGGTTTAAATGA"
    ids = playground.dna_to_context_ids(dna, stoi)
    assert ids == jplay.dna_to_context_ids(dna, stoi)
    want = jplay.query_next_codon(jdec, ids, itos, top_k=6)
    got = playground.query_next_codon(dec, ids, itos, top_k=6)
    assert [r["token"] for r in got] == [r["token"] for r in want]
    assert_rel([r["prob"] for r in got], [r["prob"] for r in want], "next-codon probs")
    want, got = jplay.score_sequence(jdec, ids), playground.score_sequence(dec, ids)
    assert got["tokens"] == want["tokens"]
    for key in ("total_logprob", "mean_logprob", "perplexity"):
        assert_rel(got[key], want[key], key)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_perplexity_and_context_ablation_match_jax(runs, impl):
    """JAX on its einsum path; the port on its einsum path and on the flash
    forward's plain version (the CPU side of the card's kernel)."""
    params, jcfg, _, _ = jax_model(runs["port"])
    model, cfg, _, _ = playground.load_codon_model(runs["port"], device="cpu")
    cfg = cfg.replace(attention_impl=impl)
    want = jppl.context_ablation(params, jcfg, runs["val"], batch_size=5)
    got = perplexity.context_ablation(model, cfg, runs["val"], batch_size=5)
    assert sorted(got) == sorted(want) == ["1", "2", "4", "full"]
    for key, row in want.items():
        assert got[key]["tokens"] == row["tokens"] and got[key]["attention_window"] == (
            row["attention_window"])
        for metric in ("nll", "perplexity", "bits_per_codon"):
            assert_rel(got[key][metric], row[metric], f"window {key} {metric}")
        assert math.isfinite(got[key]["nll"])
    assert got["1"]["nll"] != got["full"]["nll"]
    jsums, jtoks = jppl.per_row_model_nll(params, jcfg, runs["val"], batch_size=5,
                                          attention_window=2)
    sums, toks = perplexity.per_row_model_nll(model, cfg, runs["val"], batch_size=5,
                                              attention_window=2)
    np.testing.assert_array_equal(toks, jtoks)
    assert_rel(sums, jsums, "per-row NLL sums")


def test_score_mutations_match_jax_with_the_sliding_window(runs, tmp_path):
    params, jcfg, _, _ = jax_model(runs["port"])
    model, cfg, _, _ = playground.load_codon_model(runs["port"], device="cpu")
    rng = np.random.default_rng(3)
    for n_codons in (12, 2 * BLOCK + 7):  # one window; three overlapping windows
        dna = "ATG" + "".join(rng.choice(list("ACGT"), 3 * n_codons)) + "NNNTAA"
        assert mutations.dna_to_ids(dna) == jmut.dna_to_ids(dna)
        want = jmut.score_mutations(params, jcfg, dna)
        got = mutations.score_mutations(model, cfg, dna)
        assert len(got) == len(want) == n_codons + 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            assert (g["position"], g["wt_codon"]) == (w["position"], w["wt_codon"])
            assert_rel([g[k] for k in sorted(w) if k not in ("position", "wt_codon")],
                       [w[k] for k in sorted(w) if k not in ("position", "wt_codon")],
                       f"mutation row {w['position']}")
    assert mutations.score_mutations(model, cfg, "AT") == []

    from genomics_lm_torch.evals.score_mutations import main as score_cli

    run_copy = tmp_path / "run"
    shutil.copytree(runs["port"], run_copy)
    fasta = tmp_path / "cds.fa"
    fasta.write_text(">cds\n" + dna[:60] + "\n" + dna[60:] + "\n")
    assert score_cli([str(run_copy), "--dna", str(fasta), "--device", "cpu"]) == 0
    lines = (run_copy / "scores" / "mutation_scores.tsv").read_text().splitlines()
    assert len(lines) == len(got) + 1 and lines[0].split("\t")[:3] == [
        "position", "wt_codon", "wt_logp"]
