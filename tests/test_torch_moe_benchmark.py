"""PyTorch port of ``scripts/benchmark_moe.py``'s quality and throughput
sections against the JAX script.

Quality: both ``run_quality`` passes at a tiny size (40 demo genes, block
64, 2 layers, d 32, 2 experts, one epoch; the port on the CPU) must build
the same dataset, so their Markov floors are EQUAL (float64 numpy on the
same arrays), and write reports with JAX's keys, protocol strings and
variant names; each variant's validation and test NLL are finite. The
models themselves train from different inits, so their NLLs are not
compared. Throughput: one dense candidate at a tiny width in each
package's subprocess probe, then each ``run_throughput`` over that result
(the port given the tiny model, the JAX script's ``D512_MODEL`` patched to
it): the section's keys equal JAX's, the candidate rows JAX's keys plus the
port's ``ms_per_group``, ``peak_memory_bytes`` and ``last_loss``.
EP analysis: ``run_ep_analysis`` across 8 CPU ranks at a small width: rank
0's expert weight bytes in each layout equal what JAX's
``moe_param_sharding`` (or replication) leaves on device 0 of the same
8-device mesh, and ``--ep_analysis`` writes its section.
"""

from __future__ import annotations

import argparse
import json
import math

import pytest
import torch

from genomics_lm_torch.training import benchmark_moe

TINY = dict(genes=40, block_size=64, n_layer=2, n_head=2, n_embd=32, batch_size=8,
            grad_accum=1, epochs=1, lr=1e-3, warmup_steps=1, seed=1337, experts=2)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    from scripts import benchmark_moe as jax_bench

    root = tmp_path_factory.mktemp("moe_quality")
    out = {}
    for side, fn, extra in (("port", benchmark_moe.run_quality, {"device": "cpu"}),
                            ("jax", jax_bench.run_quality, {})):
        args = argparse.Namespace(workdir=str(root / side), **TINY, **extra)
        out[side] = fn(args)
    out["root"] = root
    return out


def test_quality_report_matches_jax(reports):
    got, want = reports["port"], reports["jax"]
    assert got.keys() == want.keys() == {"protocol", "markov_baselines", "variants"}
    assert got["protocol"] == want["protocol"]
    assert got["markov_baselines"] == want["markov_baselines"]  # exact: the same arrays
    assert [v["name"] for v in got["variants"]] == [v["name"] for v in want["variants"]] == [
        "dense", "moe_2e_top1", "moe_2e_top2"]
    for g, w in zip(got["variants"], want["variants"]):
        assert g.keys() == w.keys()
        assert (g["moe"], g["n_params"]) == (w["moe"], w["n_params"])
        for key in ("val_nll", "test_nll", "val_ppl", "test_ppl", "best_val_loss"):
            assert math.isfinite(g[key]) and g[key] > 0, key
    dense = got["variants"][0]
    assert dense["val_nll_delta_vs_dense"] == 0.0
    assert got["variants"][1]["n_params"] == got["variants"][2]["n_params"] > dense["n_params"]
    # the same prepared dataset on both sides
    root = reports["root"]
    for name in ("records.tsv", "dataset/manifest.json"):
        assert (root / "port" / name).read_bytes() == (root / "jax" / name).read_bytes()


def test_quality_cli_sections(tmp_path, monkeypatch, capsys):
    """``main`` runs the quality pass and its converged repeat and writes
    both sections beside a merged one; the expert-parallel flags raise."""
    calls = []

    def fake_quality(args, *, epochs=None, run_prefix="moe-quality"):
        calls.append((args.epochs if epochs is None else epochs, run_prefix, args.device))
        return {"protocol": {}, "markov_baselines": {}, "variants": []}

    monkeypatch.setattr(benchmark_moe, "run_quality", fake_quality)
    old = tmp_path / "old.json"
    old.write_text(json.dumps({"throughput_d512": {"kept": True}}))
    out = tmp_path / "report.json"
    assert benchmark_moe.main(["--skip_throughput", "--converged_epochs", "3", "--epochs", "2",
                               "--out", str(out), "--merge_into", str(old),
                               "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert report.keys() == {"throughput_d512", "quality", "quality_converged"}
    assert calls == [(2, "moe-quality", "cpu"), (3, "moe-quality-conv", "cpu")]
    assert "[moe-benchmark] wrote" in capsys.readouterr().out
    calls.clear()
    benchmark_moe.main(["--skip_throughput", "--converged_epochs", "0", "--out", str(out),
                        "--device", "cpu"])
    assert calls == [(12, "moe-quality", "cpu")]  # the script's default budget
    calls.clear()
    monkeypatch.setattr(benchmark_moe, "run_ep_analysis",
                        lambda args, device="cuda:0": calls.append((args.ep_seq_len, device))
                        or {"expert_memory_ratio": 0.5})
    benchmark_moe.main(["--skip_quality", "--skip_throughput", "--ep_analysis",
                        "--ep_seq_len", "256", "--out", str(out), "--device", "cpu"])
    assert calls == [(256, "cpu")]
    assert json.loads(out.read_text()) == {"ep_analysis": {"expert_memory_ratio": 0.5}}


def test_ep_analysis_expert_bytes_match_moe_param_sharding():
    """``run_ep_analysis`` on a small model across 8 CPU ranks: rank 0's
    expert weight bytes in each layout are what JAX's ``moe_param_sharding``
    (and replication) leaves on device 0 of the same mesh, and its report
    keeps JAX's keys."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from genomics_lm_tpu.models import codon_gpt
    from genomics_lm_tpu.models.config import CodonGPTConfig
    from genomics_lm_tpu.parallel.mesh import make_mesh
    from genomics_lm_tpu.parallel.sharding import moe_param_sharding

    tiny = dict(benchmark_moe.D512_MODEL, n_layer=2, n_head=2, n_embd=32,
                attention_impl="xla")
    args = argparse.Namespace(experts=4, ep_seq_len=16)
    torch.set_num_threads(1)
    got = benchmark_moe.run_ep_analysis(args, model=tiny, device="cpu")
    cfg = CodonGPTConfig.from_run_config(dict(tiny, block_size=16, moe_experts=4,
                                              moe_top_k=2, use_sdpa=False))
    params = codon_gpt.init(jax.random.PRNGKey(0), cfg)
    dev0 = jax.devices()[0]

    def expert_bytes(shardings):
        placed = jax.device_put(params["blocks"]["mlp"], shardings["blocks"]["mlp"])
        return sum(s.data.nbytes for leaf in jax.tree.leaves(placed)
                   for s in leaf.addressable_shards if s.device == dev0)

    rep = make_mesh(8, axes={"data": 8})
    ep = make_mesh(8, axes={"data": 4, "model": 2})
    want = {"replicated": expert_bytes(jax.tree.map(lambda _: NamedSharding(rep, P()), params)),
            "ep_sharded": expert_bytes(moe_param_sharding(params, ep, n_experts=4,
                                                          axis="model", tp_axis="model"))}
    for key, value in want.items():
        assert got[key]["expert_weight_bytes_per_device"] == value, key
        assert {r["expert_bytes"] for r in got[key]["per_rank"]} == {value}
        assert got[key]["collectives_per_step"]["total_bytes"] > 0
    assert got["expert_memory_ratio"] == 0.5
    assert set(got) == {"protocol", "replicated", "ep_sharded", "expert_memory_ratio"}
    assert set(got["ep_sharded"]) >= {"mesh", "expert_weight_bytes_per_device",
                                      "expert_moment_bytes_per_device",
                                      "total_param_bytes_per_device",
                                      "total_moment_bytes_per_device", "collectives_per_step"}
    # ZeRO-1 deals each model column's expert moments (two a weight) over its
    # 4 data ranks: the 8 ranks hold 2 columns x 2 moments of a rank's experts
    shares = [r["expert_state_bytes"] for r in got["ep_sharded"]["per_rank"]]
    assert sum(shares) == 4 * want["ep_sharded"]


def test_throughput_section_keys_match_jax(monkeypatch):
    from scripts import benchmark_moe as jax_bench
    from scripts.benchmark_training_speed import run_candidate_subprocess as jax_probe

    tiny = dict(benchmark_moe.D512_MODEL, block_size=16, n_layer=1, n_head=2, n_embd=16,
                attention_impl="xla", compute_dtype="float32")
    spec = {"model": tiny, "batch_size": 2, "grad_accum": 2, "measure_steps": 1,
            "warmup_steps": 1}
    probes = {"port": benchmark_moe.run_candidate_subprocess(dict(spec, device="cpu"), 300),
              "jax": jax_probe(spec, 300)}
    assert probes["port"]["ok"] and probes["jax"]["ok"], probes
    sections = {}
    monkeypatch.setattr(jax_bench, "D512_MODEL", tiny)
    args = argparse.Namespace(experts=4, measure_steps=1, timeout=300.0)
    for side, mod in (("port", benchmark_moe), ("jax", jax_bench)):
        monkeypatch.setattr(mod, "run_candidate_subprocess",
                            lambda spec, timeout=0.0, _r=probes[side]: dict(_r))
        sections[side] = (mod.run_throughput(args, model=tiny, device="cpu") if side == "port"
                          else mod.run_throughput(args))
    got, want = sections["port"], sections["jax"]
    assert got.keys() == want.keys() == {"protocol", "candidates"}
    assert [r["name"] for r in got["candidates"]] == [r["name"] for r in want["candidates"]] == [
        "dense", "moe_4e_top1", "moe_4e_top2"]
    for g, w in zip(got["candidates"], want["candidates"]):
        assert g.keys() - w.keys() == {"ms_per_group", "peak_memory_bytes", "last_loss"}
        assert w.keys() <= g.keys() and g["moe"] == w["moe"]
        assert g["rel_to_dense"] == w["rel_to_dense"] == 1.0
    assert got["protocol"].startswith("1L2H d16 block16 b8x16")
