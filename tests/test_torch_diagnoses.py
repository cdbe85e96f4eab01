"""The port's run diagnoses against the JAX package's scripts, on the CPU.

Two tiny run directories (2 layers, d 32, block 32, a JAX init written by
JAX's checkpoint writer, untrained; one with the termination head, one
without) and a seeded packed split (random codons, ragged PAD tails) are
read by both packages:

- ``evals/calibration_metrics.py``, ``evals/diagnose_context_learning.py``,
  ``evals/evaluate_termination_head.py`` (both runs: the head's confusion
  matrix, and the skip), ``evals/diagnose_termination_probabilities.py``,
  ``evals/run_decoding_termination_ablation.py`` and
  ``evals/benchmark_zero_shot_mutations.py`` (a seeded DMS table holding
  every mutant column name and one unscoreable row) against their scripts:
  floats within 1e-5 relative (a difference of two NLLs within 1e-5 of the
  NLL it is a difference of), counts, confusion matrices, skipped rows, top
  tokens and sampled rows exact;
- ``evals/eval_ppl_baselines.py``: the same file, byte for byte.
"""

from __future__ import annotations

import csv
import json

import jax
import numpy as np
import pytest

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.tokenizers.codon import write_itos
from genomics_lm_tpu.training.checkpoints import save_checkpoint

RTOL = 1e-5  # float32 forwards whose sums differ only in order
BLOCK = 32
MODEL = dict(vocab_size=68, block_size=BLOCK, n_layer=2, n_head=2, n_embd=32, dropout=0.0,
             sep_id=3)
WT = "ATGAAACCCGGGTTTGATCTGCAGAGCTACTGGTAA"  # 12 codons


def close(got, want, what, scale=None):
    """Equal, floats within RTOL of ``scale`` (default: the larger of the two)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for key in want:
            close(got[key], want[key], f"{what}.{key}", scale)
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, f"{what}[{i}]", scale)
    elif isinstance(want, float):
        ref = scale if scale is not None else max(abs(want), abs(float(got)))
        assert abs(float(got) - want) <= RTOL * max(ref, 1e-12), (what, got, want)
    else:
        assert got == want and type(got) is type(want), (what, got, want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("diagnoses")
    rng = np.random.default_rng(11)
    for name, n in (("train", 40), ("val", 24)):
        X = rng.integers(4, 68, (n, BLOCK)).astype(np.int32)
        X[:, 0] = 1
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 2
        for row, cut in enumerate(rng.integers(BLOCK // 2, BLOCK + 1, n)):
            X[row, cut:] = 0  # ragged PAD tails
            Y[row, cut - 1:] = 0
            if cut < BLOCK:
                Y[row, cut - 1] = 2
        np.savez(root / f"{name}.npz", X=X, Y=Y)
    paths = {"root": root, "train": root / "train.npz", "val": root / "val.npz"}
    for name, aux in (("head", True), ("plain", False)):
        run = root / "runs" / name
        (run / "checkpoints").mkdir(parents=True)
        cfg = dict(MODEL, termination_aux=aux)
        params = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(5), JaxConfig(**cfg)))
        # the init's tied embedding makes the model repeat its last codon; a
        # tenth of it spreads the next-codon law, so sampling meets stop codons
        params["tok_emb"] = params["tok_emb"] * np.float32(0.1)
        save_checkpoint({"model": params, "cfg": cfg}, run / "checkpoints" / "best.npz")
        write_itos(run / "itos.txt")
        paths[name] = run
    return paths


def both(runs, jax_main, port_main, args, name, *, run="head"):
    """Run the script and the port's CLI with ``--out`` files; their JSON."""
    out = {}
    for side, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        dest = runs["root"] / f"{name}_{side}.json"
        assert main([str(runs[run]), *args, "--out", str(dest), *extra]) == 0
        out[side] = json.loads(dest.read_text())
    return out["port"], out["jax"]


def test_calibration_matches_jax(runs, capsys):
    from genomics_lm_torch.evals.calibration_metrics import main as port
    from scripts.calibration_metrics import main as jax_main

    got, want = both(runs, jax_main, port, ["--npz", str(runs["val"]), "--batch_size", "8"],
                     "calibration")
    capsys.readouterr()
    close(got, want, "calibration")
    assert got["tokens"] > 0 and got["reliability"]


def test_context_diagnosis_matches_jax(runs, capsys):
    from genomics_lm_torch.evals.diagnose_context_learning import main as port
    from scripts.diagnose_context_learning import main as jax_main

    got, want = both(runs, jax_main, port, ["--npz", str(runs["val"]), "--batch_size", "8",
                                            "--windows", "1,4", "--position_buckets", "0,4,16"],
                     "context")
    capsys.readouterr()
    close(got["position_nll"], want["position_nll"], "position_nll")
    full = want["window_ablation"]["full"]["nll"]
    close(got["window_ablation"], want["window_ablation"], "ablation", scale=full)
    close(got["context_gain_w1_minus_full"], want["context_gain_w1_minus_full"], "gain",
          scale=full)
    assert list(got["window_ablation"]) == ["1", "4", "full"]


def test_termination_head_matches_jax_and_skips_alike(runs, capsys):
    from genomics_lm_torch.evals.evaluate_termination_head import main as port
    from scripts.evaluate_termination_head import main as jax_main

    got, want = both(runs, jax_main, port, ["--npz", str(runs["val"]), "--batch_size", "8"],
                     "term_head")
    capsys.readouterr()
    close(got, want, "termination_head")
    assert got["tokens"] == sum(c["support"] for c in got["per_class"].values()) > 0
    skipped = []
    for main, extra in ((jax_main, []), (port, ["--device", "cpu"])):
        assert main([str(runs["plain"]), "--npz", str(runs["val"]), *extra]) == 0
        skipped.append(json.loads(capsys.readouterr().out))
    assert skipped[0] == skipped[1] and "skipped" in skipped[1]


def test_termination_probabilities_match_jax(runs, capsys):
    from genomics_lm_torch.evals.diagnose_termination_probabilities import main as port
    from scripts.diagnose_termination_probabilities import main as jax_main

    got, want = both(runs, jax_main, port, ["--dna", "ATGAAA", "--n_steps", "6", "--seed", "3"],
                     "term_probs")
    capsys.readouterr()
    close(got, want, "termination_probabilities")
    assert [r["context_len"] for r in got] == list(range(3, 9))


def test_termination_ablation_matches_jax(runs, capsys):
    from genomics_lm_torch.evals.run_decoding_termination_ablation import main as port
    from scripts.run_decoding_termination_ablation import main as jax_main

    got, want = both(runs, jax_main, port, ["--biases", "0,4", "--n_samples", "2",
                                            "--target_codons", "4", "--hard_cap", "8"],
                     "term_ablation")
    capsys.readouterr()
    close(got, want, "termination_ablation")
    assert [r["stop_bias"] for r in got] == [0.0, 4.0]


def test_zero_shot_dms_matches_jax(runs, capsys):
    from genomics_lm_torch.evals.benchmark_zero_shot_mutations import main as port
    from scripts.benchmark_zero_shot_mutations import main as jax_main

    rng = np.random.default_rng(4)
    table = runs["root"] / "dms.csv"
    columns = ("mutant_codon", "mut_codon", "mutant")
    with table.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["position", *columns, "fitness"])
        writer.writeheader()
        for i in range(9):
            row = {"position": int(rng.integers(0, 12)), "fitness": float(rng.normal())}
            codon = "".join(rng.choice(list("ACGT"), 3))
            row[columns[i % 3]] = codon.lower() if i % 2 else codon
            writer.writerow(row)
        writer.writerow({"position": 40, "mutant_codon": "GCT", "fitness": 0.5})  # no such codon
    got, want = both(runs, jax_main, port, ["--dna", WT, "--dms_csv", str(table)], "dms")
    capsys.readouterr()
    close(got, want, "dms")
    assert (got["n_variants"], got["skipped"]) == (9, 1)


def test_ppl_baselines_file_is_byte_equal(runs, capsys):
    from genomics_lm_torch.evals.eval_ppl_baselines import main as port
    from scripts.eval_ppl_baselines import main as jax_main

    texts = []
    for side, main in (("jax", jax_main), ("port", port)):
        dest = runs["root"] / f"baselines_{side}.json"
        assert main(["--train_npz", str(runs["train"]), "--eval_npz", str(runs["val"]),
                     "--alpha", "0.5", "--out", str(dest)]) == 0
        texts.append(dest.read_bytes())
    capsys.readouterr()
    assert texts[0] == texts[1]
    assert json.loads(texts[1])["eval_tokens"] > 0
