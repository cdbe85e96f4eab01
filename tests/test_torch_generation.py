"""PyTorch port of constrained generation and its CLIs against the JAX package.

Each generator of ``generation/constrained.py`` runs over the port's
``CachedDecoder`` and over JAX's on the same float32 weights, from the same
``np.random.default_rng(seed)``: the ids must be equal token for token and
the ``info`` dicts key for key. That covers the termination stop bias and
the multi-offset prior (a model with those heads), a context longer than
the block (the decoder's clip-and-recompute path) and a numpy critic. The
invariants of ``tests/test_generation.py`` hold as well. The CLIs run with
``--device cpu``: ``query_model --mode generate`` prints the JSON of
``scripts/query_model.py`` for the same seed, ``serve_model --int8_weights``
answers ``/generate`` over localhost, and ``benchmark_serving
--arrival_rate`` reports a TTFT for each request.
"""

from __future__ import annotations

import http.client
import json

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu.generation import constrained as jgen
from genomics_lm_tpu.generation.decode import CachedDecoder as JaxDecoder
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_torch.generation import constrained as gen
from genomics_lm_torch.generation.decode import CachedDecoder
from genomics_lm_torch.generation.genetic_code import CODON_TABLE, translate_codons_to_aa
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.tokenizers.codon import VOCAB, stoi, write_itos
from genomics_lm_torch.training.checkpoints import save_checkpoint
from genomics_lm_torch.utils.weights import params_from_jax

ITOS = list(VOCAB)
BLOCK = 24
HEADS = dict(termination_aux=True, multi_offset_targets=(2, 3))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_pair(seed=0, **over):
    kw = dict(vocab_size=68, block_size=BLOCK, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
              sep_id=3)
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return JaxDecoder(params, jcfg), CachedDecoder(model, tcfg)


def noisy_critic(aa_seqs):
    """A deterministic numpy critic: favours K and M, penalises L."""
    return np.asarray([0.7 * s.count("K") + 0.3 * s.count("M") - 0.5 * s.count("L")
                       for s in aa_seqs], np.float64)


GENERATORS = {
    "raw": lambda m, d, ctx, rng: m.generate_model_raw(
        d, ctx, stoi, ITOS, 12, temperature=0.9, topk=20, rng=rng),
    "constrained": lambda m, d, ctx, rng: m.generate_cds_constrained(
        d, ctx, stoi, ITOS, target_codons=6, hard_cap=10, rng=rng),
    "termination_bias_and_offset_prior": lambda m, d, ctx, rng: m.generate_cds_constrained(
        d, ctx, stoi, ITOS, target_codons=6, hard_cap=9, termination_bias_enabled=True,
        termination_stop_bias=3.0, termination_trigger_class_max=2,
        termination_bias_window=4, multi_offset_prior_enabled=True,
        multi_offset_prior_weights={2: 0.5, 3: 0.25}, rng=rng),
    "termination_bias": lambda m, d, ctx, rng: m.generate_cds_constrained(
        d, ctx, stoi, ITOS, target_codons=8, hard_cap=12, require_terminal_stop=True,
        termination_bias_enabled=True, termination_stop_bias=4.0,
        termination_trigger_class_max=4, termination_bias_window=8, rng=rng),
    "red": lambda m, d, ctx, rng: m.generate_cds_red(
        d, ctx, stoi, ITOS, target_codons=3, hard_cap=6, max_attempts=3, rng=rng),
    "batch_red": lambda m, d, ctx, rng: m.batch_red_sampler(
        d, [ctx, ctx + [stoi["ATG"]], ctx[:2]], stoi, ITOS, target_codons=3, hard_cap=12,
        global_token_budget=60, temperature=3.0, rng=rng),
    "critic_guided": lambda m, d, ctx, rng: m.generate_cds_critic_guided(
        d, noisy_critic, ctx, stoi, ITOS, target_codons=6, hard_cap=9, alpha=0.8,
        guide_top_k=4, temperature=1.2, rng=rng),
    "synonymous": lambda m, d, ctx, rng: m.generate_cds_synonymous(
        d, ctx, stoi, ITOS, "MKVLST", rng=rng),
    "synonymous_critic": lambda m, d, ctx, rng: m.generate_cds_synonymous(
        d, ctx, stoi, ITOS, "MKWYLH", score_fn=noisy_critic, alpha=0.5, guide_top_k=3,
        temperature=0.8, rng=rng),
}


@pytest.mark.parametrize("long_context", [False, True], ids=["short_ctx", "ctx_over_block"])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match_jax(name, long_context):
    jdec, tdec = make_pair(**HEADS)
    rng = np.random.default_rng(7)
    ctx = [1, stoi["ATG"]] + [int(t) for t in rng.integers(4, 68, 28 if long_context else 3)]
    run = GENERATORS[name]
    want = run(jgen, jdec, ctx, np.random.default_rng(11))
    got = run(gen, tdec, ctx, np.random.default_rng(11))
    assert got == want


def test_invariants_of_the_jax_tests():
    _, dec = make_pair()
    rng = np.random.default_rng(0)
    ctx = [1, stoi["ATG"]]
    ids, info = gen.generate_cds_constrained(dec, ctx, stoi, ITOS, target_codons=5,
                                             hard_cap=10, rng=rng)
    assert all(gen._is_codon(ITOS[t]) for t in ids[len(ctx):])
    assert info["generated_codons"] <= 10 and info["protocol"] == "cds_constrained"

    solved, remaining, total = gen.batch_red_sampler(
        dec, [[1], ctx], stoi, ITOS, target_codons=3, hard_cap=6, global_token_budget=60,
        rng=rng)
    assert total <= 60 + 6  # one in-flight attempt may finish
    assert set(solved) | set(remaining) == {0, 1}

    ids, info = gen.generate_cds_synonymous(dec, [1], stoi, ITOS, "MKV", rng=rng)
    codons = [ITOS[t] for t in ids[1:] if gen._is_codon(ITOS[t])]
    assert translate_codons_to_aa(codons[:-1]) == "MKV"
    assert codons[-1] in gen.STOP_CODONS and ids[-1] == stoi["<EOS_CDS>"]
    assert CODON_TABLE["ATG"] == "M" and len(CODON_TABLE) == 64


# --- the CLIs ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory: ``checkpoints/best.npz`` in the trainers' format (the
    model tree and its run config) and ``itos.txt``."""
    root = tmp_path_factory.mktemp("gen_run")
    cfg = dict(block_size=64, n_layer=2, n_head=4, n_embd=32, dropout=0.0, sep_id=3)
    jcfg = JaxConfig(vocab_size=68, **cfg)
    params = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(3), jcfg))
    (root / "checkpoints").mkdir()
    save_checkpoint({"model": params, "cfg": dict(cfg, vocab_size=68)},
                    root / "checkpoints" / "best.npz")
    write_itos(root / "itos.txt")
    return root


def cli_json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_query_model_generate_prints_the_jax_scripts_json(run_dir, capsys):
    from genomics_lm_torch.generation.query_model import main as port_query
    from scripts.query_model import main as jax_query

    argv = [str(run_dir), "--mode", "generate", "--dna", "ATGGCTAAA", "--target_codons", "6",
            "--hard_cap", "12", "--seed", "5"]
    want = cli_json(jax_query, argv, capsys)
    got = cli_json(port_query, argv + ["--device", "cpu"], capsys)
    assert got == want


def test_query_model_next_score_and_sample(run_dir, capsys):
    from genomics_lm_torch.generation.query_model import main as port_query
    from genomics_lm_torch.generation.sample import main as sample
    from scripts.query_model import main as jax_query

    for mode in ("next", "score"):
        argv = [str(run_dir), "--mode", mode, "--dna", "ATGGCTAAACCC", "--top_k", "5"]
        want = cli_json(jax_query, argv, capsys)
        got = cli_json(port_query, argv + ["--device", "cpu"], capsys)
        if mode == "next":
            assert [r["token"] for r in got["next"]] == [r["token"] for r in want["next"]]
            np.testing.assert_allclose([r["prob"] for r in got["next"]],
                                       [r["prob"] for r in want["next"]], rtol=1e-5)
        else:
            np.testing.assert_allclose(got["total_logprob"], want["total_logprob"], rtol=1e-5)
            assert got["tokens"] == want["tokens"]
    with pytest.raises(NotImplementedError, match="interactive"):
        port_query([str(run_dir), "--mode", "interactive", "--device", "cpu"])
    assert sample([str(run_dir), "--max_new_tokens", "8", "--device", "cpu"]) == 0
    dna, tail = capsys.readouterr().out.strip().splitlines()
    assert dna.startswith("ATG") and set(dna) <= set("ACGT") and "stop_reason=" in tail


def test_benchmark_red_cli(run_dir, tmp_path, capsys):
    from genomics_lm_torch.generation.benchmark_red import main as bench_red

    out = tmp_path / "red.json"
    report = cli_json(bench_red, [str(run_dir), "--n_prefixes", "2", "--target_codons", "3",
                                  "--hard_cap", "6", "--max_attempts", "2", "--out",
                                  str(out), "--device", "cpu"], capsys)
    assert report == json.loads(out.read_text())
    assert 1.0 <= report["red"]["mean_attempts"] <= 2.0


def test_serve_model_int8_answers_generate(run_dir):
    from genomics_lm_torch.serving.serve_model import build_server, parser

    server = build_server(parser().parse_args(
        ["--run", str(run_dir), "--port", "0", "--slots", "2", "--max_seq_len", "64",
         "--int8_weights", "--device", "cpu"]))
    server.start()
    try:
        conn = http.client.HTTPConnection(*server.address, timeout=60)
        conn.request("POST", "/generate", json.dumps({"dna": "ATGGCTAAA",
                                                      "max_new_tokens": 6}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = json.loads(resp.read())
        conn.close()
    finally:
        server.stop()
    assert resp.status == 200 and len(reply["tokens"]) == 6
    assert reply["finish_reason"] == "length"


@pytest.mark.parametrize("protocol", ["closed_loop", "open_loop"])
def test_benchmark_serving_cli(protocol, capsys):
    from genomics_lm_torch.serving.benchmark_serving import main as bench_serving

    argv = ["--n_layer", "1", "--n_head", "2", "--n_embd", "32", "--block_size", "64",
            "--slots", "4", "--max_seq_len", "48", "--requests", "6", "--prompt_len_min",
            "4", "--prompt_len_max", "8", "--new_tokens_min", "4", "--new_tokens_max", "8",
            "--steps_per_sync", "4", "--repeats", "1", "--int8_weights", "--device", "cpu"]
    if protocol == "open_loop":
        argv += ["--arrival_rate", "200"]
    report = cli_json(bench_serving, argv, capsys)
    assert report["int8_weights"] is True
    if protocol == "open_loop":
        assert report["metric"] == "serving_latency_ms"
        assert len(report["ttft_ms"]) == 6 and all(t >= 0 for t in report["ttft_ms"])
        assert report["ttft_p50_ms"] <= report["ttft_p99_ms"]
    else:
        assert report["metric"] == "serving_delivered_tokens_per_sec_per_chip"
        assert report["value"] > 0 and report["delivered_tokens"] > 0
