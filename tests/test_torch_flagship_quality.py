"""The port's flagship quality benchmark (``evals/benchmark_flagship_quality.py``)
against ``scripts/benchmark_flagship_quality.py`` at a toy size.

One JAX init seeds one JAX run and one port run, each trained by its own
package's trainer with its own script's ``train_cfg`` into its workdir's
``runs/flagship-d512`` (bf16, flash, fused QKV; at block 64, under the
script's 512-wide flash tiles, JAX's attention takes its XLA path and the
port's its plain version on the CPU). Then both benchmark CLIs run and
reuse their completed runs:

- the two workdirs' datasets are byte-equal;
- the Markov baselines agree within ``BASELINE_ATOL``;
- the hardest baseline, the best simple model, the token counts, the
  bootstrap's row counts and ``beats_hardest_with_ci`` (so the exit codes)
  are equal;
- the model NLL, the margins, their intervals and the context ablation
  agree within ``MODEL_ATOL`` (stated below).
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_tpu.training import loop as jax_loop
from genomics_lm_torch.evals import benchmark_flagship_quality as port_fq
from genomics_lm_torch.training import loop
from scripts import benchmark_flagship_quality as jax_fq

# Count tables from the same bytes, summed by two numpy codes: equal up to
# the order of float64 sums.
BASELINE_ATOL = 1e-12
# The two runs train in bf16 with float32 accumulation whose sums run in a
# different order (XLA's CPU dots and fused attention against torch's CPU
# kernels), so the trained weights part at bf16's resolution: the NLLs
# (~4 nats) and every margin or interval built on them agree to 2e-2 nats
# (5.5e-3 the largest difference seen, the window-1 ablation), half the
# margin this toy run shows over the uniform law.
MODEL_ATOL = 2e-2
TOY = ["--genes", "120", "--block_size", "64", "--n_layer", "2", "--n_head", "2",
       "--n_embd", "32", "--dropout", "0", "--batch_size", "8", "--lr", "2e-2",
       "--warmup_steps", "2", "--epochs", "1", "--bootstrap", "200"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both workdirs trained from one init, then both benchmark CLIs run.
    JAX's init runs compiled whole (one compile instead of one per random
    draw); the trainers' own inits are overwritten by the shared one."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gpt, "init", jax.jit(jax_gpt.init, static_argnums=1))
        return train_and_report(tmp_path_factory.mktemp("flagship"))


def train_and_report(root):
    args = port_fq.parser().parse_args(TOY)
    jcfg = None
    init = root / "init" / "checkpoints" / "init.npz"
    out = {}
    for side, fq, trainer, extra in (("jax", jax_fq, jax_loop.run_training, {}),
                                     ("port", port_fq, loop.run_training,
                                      {"device": "cpu"})):
        workdir = root / side
        dataset = fq.build_dataset(workdir, genes=args.genes, block_size=args.block_size,
                                   seed=args.seed)
        cfg = fq.train_cfg(args, dataset)
        if jcfg is None:
            jcfg = JaxConfig.from_run_config(cfg)
            init.parent.mkdir(parents=True)
            params = jax_gpt.init(jax.random.PRNGKey(5), jcfg)
            jckpt.save_checkpoint({"model": jax.tree.map(np.asarray, params)}, init)
            (root / "init" / "itos.txt").write_text((dataset / "itos.txt").read_text())
        meta = trainer(cfg, transfer_from=str(init), run_root=workdir / "runs", **extra)
        assert meta["status"] == "completed"
        report_path = workdir / "report.json"
        argv = TOY + ["--workdir", str(workdir), "--out", str(report_path)]
        rc = (jax_fq.main(argv) if side == "jax"
              else port_fq.main(argv + ["--device", "cpu"]))
        out[side] = {"rc": rc, "dataset": dataset, "meta": meta,
                     "report": json.loads(report_path.read_text())}
    return out


def close(got, want, atol, what):
    assert abs(float(got) - float(want)) <= atol, (what, got, want)


def test_datasets_are_byte_equal(reports):
    jax_dir, port_dir = reports["jax"]["dataset"], reports["port"]["dataset"]
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    assert "train_bs64.npz" in names and "manifest.json" in names
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


@pytest.mark.parametrize("split", ["val", "test"])
def test_split_report_matches_the_script(reports, split):
    got, want = reports["port"]["report"][split], reports["jax"]["report"][split]
    assert got.keys() == want.keys()
    for key in ("hardest_baseline", "best_simple_model", "tokens", "beats_hardest_with_ci"):
        assert got[key] == want[key], key
    assert got["baselines"].keys() == want["baselines"].keys()
    for name, base in want["baselines"].items():
        assert got["baselines"][name].keys() == base.keys()
        for key, value in base.items():
            close(got["baselines"][name][key], value,
                  BASELINE_ATOL * max(1.0, abs(value)), f"{split}.{name}.{key}")
    assert got["model"]["tokens"] == want["model"]["tokens"] == got["tokens"]
    close(got["model"]["nll"], want["model"]["nll"], MODEL_ATOL, f"{split} nll")
    assert got["margins"].keys() == want["margins"].keys()
    for name, margin in want["margins"].items():
        for key in ("n_rows", "n_boot", "ci_level"):
            assert got["margins"][name][key] == margin[key], (name, key)
        for key in ("margin_nats", "ci_low", "ci_high"):
            close(got["margins"][name][key], margin[key], MODEL_ATOL, f"{split}.{name}.{key}")
    # the toy run learns: it beats the uniform law by more than the tolerance
    assert got["margins"]["Uniform"]["margin_nats"] > 2 * MODEL_ATOL


def test_train_block_ablation_and_exit_code_match(reports):
    got, want = reports["port"]["report"], reports["jax"]["report"]
    assert got.keys() == want.keys()
    assert got["config"] == want["config"]
    assert got["protocol"].keys() == want["protocol"].keys()
    assert "the port's flash kernels" in got["protocol"]["model"]
    assert got["train"]["n_params"] == want["train"]["n_params"]
    close(got["train"]["best_val_loss"], want["train"]["best_val_loss"], MODEL_ATOL,
          "best_val_loss")
    assert got["context_ablation"].keys() == want["context_ablation"].keys()
    for window, row in want["context_ablation"].items():
        assert got["context_ablation"][window]["tokens"] == row["tokens"]
        assert got["context_ablation"][window]["attention_window"] == row["attention_window"]
        close(got["context_ablation"][window]["nll"], row["nll"], MODEL_ATOL, window)
    assert reports["port"]["rc"] == reports["jax"]["rc"] == (
        0 if want["test"]["beats_hardest_with_ci"] else 1)
    assert reports["port"]["meta"]["consumed_train_tokens"] > 0
