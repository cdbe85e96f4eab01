"""The port's whole-generation decode benchmark against
``scripts/benchmark_decode.py``, on the CPU.

One JAX init (1 layer, 2 heads, d 32, float32, the plain path, as the
script builds it off the TPU) goes into the port through ``params_from_jax``;
B 2 prompts of 4 codons, 8 tokens at temperature 0:

- ``serving/benchmark_decode.py``'s ``scan`` and ``stepwise`` runs emit
  JAX's ``generate_tokens`` greedy tokens, token for token;
- under ``--speculative 2`` with the draft table JAX fits (the script's
  self-sampled stream), the run emits JAX's ``generate_tokens_speculative``
  tokens, with the same row-rounds and emitted counts (so the same
  ``accept_rate`` and ``tokens_per_round``);
- the report's keys and fixed fields equal the script's, plain and under
  ``--int8_weights --kv_quant --speculative 2``.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genomics_lm_tpu.generation.decode import generate_tokens as jax_generate
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.serving import speculative as jax_spec
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.serving import benchmark_decode as bd
from genomics_lm_torch.utils.weights import params_from_jax

MODEL = dict(vocab_size=68, block_size=32, n_layer=1, n_head=2, n_embd=32, dropout=0.0,
             sep_id=3, compute_dtype="float32", fused_qkv=False, attention_impl="xla")
SIZE = ["--n_layer", "1", "--n_head", "2", "--n_embd", "32", "--block_size", "32",
        "--batch_size", "2", "--prefill_len", "4"]


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxConfig(**MODEL)
    params = jax_gpt.init(jax.random.PRNGKey(0), jcfg)
    # a tenth of the tied embedding spreads the next-codon law (the init
    # repeats its last codon), so greedy tokens vary along a row
    params = dict(params, tok_emb=params["tok_emb"] * 0.1)
    cfg = CodonGPTConfig(**MODEL)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    args = bd.parser().parse_args([*SIZE, "--decode_tokens", "8", "--temperature", "0",
                                   "--device", "cpu"])
    return {"jcfg": jcfg, "params": params, "cfg": cfg, "model": model, "args": args,
            "prompt": bd.make_prompt(args)}


@pytest.mark.parametrize("mode", ["scan", "stepwise"])
def test_greedy_tokens_equal_jax(pair, mode):
    args = pair["args"]
    args.mode = mode
    run_once = bd.make_run_once(pair["model"], pair["cfg"], pair["prompt"], args, "cpu")
    got = run_once(1).numpy()
    want = np.asarray(jax_generate(pair["params"], pair["jcfg"], jnp.asarray(pair["prompt"]),
                                   8, jax.random.PRNGKey(1), 0.0, False))
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[0].tolist())) > 1


def test_speculative_tokens_and_counts_equal_jax(pair):
    args = bd.parser().parse_args([*SIZE, "--decode_tokens", "8", "--temperature", "0",
                                   "--speculative", "2", "--device", "cpu"])
    prompt = jnp.asarray(pair["prompt"])
    stream = np.asarray(jax_generate(pair["params"], pair["jcfg"], prompt[:2], 28,
                                     jax.random.PRNGKey(42), 1.0, False))
    table = jax_spec.fit_bigram_table([row for row in stream], 68)
    want, want_rounds, want_emitted = jax_spec.generate_tokens_speculative(
        pair["params"], pair["jcfg"], prompt, 8, jax.random.PRNGKey(1),
        jnp.asarray(table, jnp.float32), 2, 0.0, False)
    stats = {}
    run_once = bd.make_run_once(pair["model"], pair["cfg"], pair["prompt"], args, "cpu",
                                table, stats)
    np.testing.assert_array_equal(run_once(1).numpy(), np.asarray(want))
    assert stats["_last"] == (int(want_rounds), int(want_emitted))


def test_report_keys_equal_the_script(capsys):
    from scripts.benchmark_decode import main as jax_main

    fixed = ("metric", "unit", "batch_size", "prefill_len", "decode_tokens", "mode", "model",
             "int8_weights", "kv_quant", "attention_impl", "speculative_k")
    for flags in ([], ["--int8_weights", "--kv_quant", "--speculative", "2"]):
        argv = [*SIZE, "--decode_tokens", "4", "--measure_rounds", "1", *flags]
        reports = []
        for main, extra in ((jax_main, []), (bd.main, ["--device", "cpu"])):
            capsys.readouterr()
            assert main(argv + extra) == 0
            reports.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
        want, got = reports
        assert list(got) == list(want), flags
        assert {k: got[k] for k in fixed if k in got} == {k: want[k] for k in fixed if k in want}
        assert got["value"] > 0 and got["ms_per_decode_step"] > 0
