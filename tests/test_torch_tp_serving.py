"""Tensor-parallel serving of the port against the meshless engine and JAX's.

Two ranks (``genomics_lm_torch.parallel.launch.spawn``, gloo over a
``file://`` store, the torch-only ``workers.serve`` in each child) run one
``ServingEngine`` each under a ``model`` mesh of 2: each holds its heads of
the blocks and its heads' lanes of the packed cache. Their greedy drains,
float32 with a float32 or int8 KV cache and speculative K 4, must equal the
meshless port engine's and JAX's engine's token for token; a bf16 drain and
sampled requests must equal across the ranks and the bf16 greedy ones the
meshless port engine's. Each rank's state is JAX's ``serving_state_sharding``
split of the meshless engine's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.parallel import mesh as jax_mesh
from genomics_lm_tpu.serving import engine as jax_engine
from genomics_lm_torch.parallel import workers, launch

MODEL = dict(vocab_size=68, block_size=64, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
             sep_id=3, fused_qkv=True, n_kv_head=2, attention_impl="flash")
ENGINE = dict(slots=3, max_seq_len=48, steps_per_sync=4)
N_REQ = 5


def requests(temperature=0.0):
    rng = np.random.default_rng(0)
    return [([1] + [int(t) for t in rng.integers(4, 68, 3 + 2 * i)], 12 + i,
             temperature if i % 2 else 0.0) for i in range(N_REQ)]


CASES = {
    "f32": ({}, {}),
    "f32_int8_cache": ({}, {"kv_quant": True}),
    "spec4": ({}, {"speculative_k": 4}),
    "spec4_int8_cache": ({}, {"speculative_k": 4, "kv_quant": True}),
    "bf16": ({"compute_dtype": "bfloat16"}, {}),
    "sampled": ({}, {"seed": 3}),
}


@pytest.fixture(scope="module")
def drains():
    params = jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**MODEL))
    tree = jax.tree.map(np.asarray, params)
    table = np.full((68, 68), 1.0 / 68)
    specs = []
    for name, (model_over, engine_over) in CASES.items():
        engine = dict(ENGINE, **engine_over)
        if engine.get("speculative_k"):
            engine["draft_table"] = table
        reqs = requests(0.9 if name == "sampled" else 0.0)
        specs.append({"model": dict(MODEL, **model_over), "tree": tree, "engine": engine,
                      "requests": reqs})
    ranks = launch.spawn(workers.serve, 2, specs, device="cpu")
    torch.set_num_threads(1)
    meshless = [workers.serve(0, 1, dict(s, mesh=False, device="cpu")) for s in specs]
    jax_tokens = {}
    for kv_quant in (False, True):
        eng = jax_engine.ServingEngine(params, JaxConfig(**MODEL), kv_quant=kv_quant,
                                       **ENGINE)
        for prompt, n, _ in requests():
            eng.submit(prompt, n)
        jax_tokens[kv_quant] = {rid: list(r.tokens) for rid, r in eng.run().items()}
    return {name: {"ranks": [r[i] for r in ranks], "meshless": meshless[i]}
            for i, name in enumerate(CASES)} | {"jax": jax_tokens}


@pytest.mark.parametrize("case", list(CASES))
def test_tp2_drain_matches_meshless_and_jax(drains, case):
    run = drains[case]
    r0, r1 = run["ranks"]
    assert r0["tokens"] == r1["tokens"]  # the ranks' caches never part
    assert r0["stats"]["tensor_parallel"] and not run["meshless"]["stats"]["tensor_parallel"]
    greedy = range(0, N_REQ, 2) if case == "sampled" else range(N_REQ)
    for rid in greedy:
        assert r0["tokens"][rid] == run["meshless"]["tokens"][rid], rid
    assert [len(r0["tokens"][rid]) for rid in range(N_REQ)] == [n for _, n, _ in requests()]
    if case in ("f32", "spec4", "f32_int8_cache", "spec4_int8_cache"):
        want = drains["jax"]["int8" in case]
        for rid in range(N_REQ):
            assert r0["tokens"][rid] == want[rid], rid


def test_serving_state_split_matches_jax(drains):
    """Each rank's engine state: JAX's ``serving_state_sharding`` split of
    the meshless engine's (the cache lanes and the scales' heads halved)."""
    jcfg = JaxConfig(**MODEL)
    jstate = jax_engine.init_serving_state(jcfg, 3, 48, kv_quant=True)
    specs = jax_engine.serving_state_sharding(jstate, jax_mesh.make_mesh(2, axes={"model": 2}))
    run = drains["f32_int8_cache"]
    full = run["meshless"]["state_shapes"]
    assert set(full) == set(specs)
    for rank in run["ranks"]:
        for name, shape in rank["state_shapes"].items():
            want = [n // 2 if axis == "model" else n
                    for n, axis in zip(full[name], tuple(specs[name].spec) + (None,) * 4)]
            assert list(shape) == want, name
