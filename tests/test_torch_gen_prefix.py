"""PyTorch port of the prefix-generation benchmark and the generative design
loop against the JAX package.

- ``evals/gen_prefix.py::token_nlls`` on the einsum and the flash path
  (JAX's flash kernel in interpret mode, the port's plain version), windows
  within and over the block: within 1e-5 of the largest.
- ``score_sample`` (with the controls and the memorization audit),
  ``summarize_by_k`` and ``replay_records``: floats within 1e-5, everything
  else equal; the replay records load through the port's ``data/replay.py``.
- ``data/leakage.py::audit_generated_sequences``: equal reports.
- The CLIs on one tiny run (2 layers, d 64, block 64, a JAX init in the
  trainers' checkpoint format over a prepared demo corpus) against the JAX
  scripts: ``eval_generation_prefix`` (raw, constrained and a guided
  protocol; CSV rows, manifest, FASTA and replay), ``build_generated_prefix_replay``,
  ``generative_design_loop`` (candidates and summary, wall time excluded)
  and ``audit_generated_sequences``. The port's generators match JAX's token
  for token from one seed, so every generated sequence is equal.
- The critic and EBM flags on a JAX-initialized critic and EBM: each flag's
  ``eval_generation_prefix`` rows (critic- and EBM-guided generation, the
  synonymous generator under the EBM, ``--critic_stability``) and, with
  ``--critic_ckpt``/``--ebm_ckpt``, the design loop's candidates, critic
  columns and report equal JAX's.
"""

from __future__ import annotations

import csv
import json

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu.data import leakage as jax_leakage
from genomics_lm_tpu.evals import gen_prefix as jax_gp
from genomics_lm_tpu.generation.decode import CachedDecoder as JaxDecoder
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_torch.data import leakage
from genomics_lm_torch.data.demo_corpus import main as demo_corpus
from genomics_lm_torch.data.pipeline import prepare_dataset
from genomics_lm_torch.data.replay import GeneratedTerminationReplayDataset
from genomics_lm_torch.evals import gen_prefix as gp
from genomics_lm_torch.generation.decode import CachedDecoder
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.tokenizers.codon import VOCAB, stoi, write_itos
from genomics_lm_torch.training.checkpoints import save_checkpoint
from genomics_lm_torch.utils.weights import params_from_jax

TOL = 1e-5  # float32 forwards whose sums differ only in order
BLOCK = 64
ITOS = list(VOCAB)
MODEL = dict(vocab_size=68, block_size=BLOCK, n_layer=2, n_head=2, n_embd=64, dropout=0.0,
             sep_id=3)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_forward():
    """JAX's ``codon_gpt.forward`` compiled whole for the module: the same
    function, one compile per window length for every case instead of one
    eager dispatch per primitive at every call (``token_nlls`` scores each
    sample through it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gpt, "forward", jax.jit(
            jax_gpt.forward, static_argnums=1,
            static_argnames=("train", "return_aux", "attention_window")))
        yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    elif isinstance(want, float) or (isinstance(want, str) and _is_float(want)
                                     and not want.isdigit()):
        g, w = float(got), float(want)
        if np.isnan(w):
            assert np.isnan(g), what
        else:
            assert abs(g - w) <= TOL * max(1.0, abs(w)), (what, got, want)
    else:
        assert got == want, (what, got, want)


def _is_float(text: str) -> bool:
    try:
        float(text)
    except ValueError:
        return False
    return True


def decoder_pair(impl="xla", seed=2):
    kw = dict(MODEL, attention_impl=impl)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return JaxDecoder(params, jcfg), CachedDecoder(model, tcfg)


@pytest.mark.parametrize("impl", ["xla", "flash"], ids=["einsum", "flash"])
def test_token_nlls_match_jax(impl):
    jdec, tdec = decoder_pair(impl)
    rng = np.random.default_rng(0)
    for n in (1, 2, 17, BLOCK + 1, BLOCK + 9):
        ids = [1] + [int(t) for t in rng.integers(4, 68, n - 1)]
        want = jax_gp.token_nlls(jdec, ids)
        got = gp.token_nlls(tdec, ids)
        assert got.shape == want.shape == (min(max(n - 1, 0), BLOCK),)
        if got.size:
            assert float(np.abs(got - want).max()) <= TOL * max(1.0, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A prepared demo corpus (block 64) and a run directory holding a JAX init
    in the trainers' checkpoint format."""
    root = tmp_path_factory.mktemp("gen_prefix_run")
    demo_corpus(["--out", str(root / "records.tsv"), "--genes", "60", "--seed", "2",
                 "--min_codons", "30", "--max_codons", "100"])
    with (root / "records.tsv").open() as f:
        records = list(csv.DictReader(f, delimiter="\t"))
    data = root / "dataset"
    prepare_dataset(records, data, block_size=BLOCK, split_seed=2, skip_homology=True)
    run = root / "runs" / "tiny"
    (run / "checkpoints").mkdir(parents=True)
    params = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(3), JaxConfig(**MODEL)))
    # the init's tied embedding makes the model repeat its last codon; a tenth
    # of it gives a spread next-codon law, so ReD meets stop codons
    params["tok_emb"] = params["tok_emb"] * np.float32(0.1)
    save_checkpoint({"model": params, "cfg": dict(MODEL)}, run / "checkpoints" / "best.npz")
    write_itos(run / "itos.txt")
    return {"run": run, "data": data, "records": records, "root": root}


def test_score_sample_summary_and_replay_match_jax(tiny):
    jdec, tdec = decoder_pair(seed=3)
    train = [str(tiny["data"] / f"train_bs{BLOCK}.npz")]
    unigram, mask = gp.fit_train_unigram(train, ITOS)
    want_unigram, want_mask = jax_gp.fit_train_unigram(train, ITOS)
    np.testing.assert_array_equal(unigram, want_unigram)
    np.testing.assert_array_equal(mask, want_mask)
    indexes = gp.build_train_ngram_indexes(train, [3, 10], max_tokens=5000)
    assert indexes == jax_gp.build_train_ngram_indexes(train, [3, 10], max_tokens=5000)

    rng = np.random.default_rng(1)
    codons = [c for c in ITOS if len(c) == 3]
    samples = {"jax": [], "port": []}
    for i in range(4):
        truth = list(rng.choice(codons, 30))
        k = (1, 3)[i % 2]
        gen_len = 24 - k  # two window lengths in all: JAX compiles one forward per length
        generated = [1] + [stoi[c] for c in truth[:k]] + \
            [int(t) for t in rng.integers(4, 68, gen_len)]
        info = {"had_terminal_stop": i % 3 == 0, "hit_hard_cap": i % 2 == 0,
                "stop_reason": "cap"}
        for name, mod, dec in (("jax", jax_gp, jdec), ("port", gp, tdec)):
            samples[name].append(mod.score_sample(
                decoder=dec, protocol=("cds_constrained", "raw_model")[i % 2], gene_idx=i // 2,
                k=k, sample_id=i, sample_seed=100 + i, generated_ids=generated,
                prefix_len_tokens=k + 1, info=info, truth_codons=truth, itos=ITOS, stoi=stoi,
                unigram=unigram, codon_mask=mask, ngram_indexes=indexes, nll_controls=True))
    for got, want in zip(samples["port"], samples["jax"]):
        assert_close(vars(got), vars(want), "sample")
    assert "delta_shuffled" in samples["port"][0].metrics
    kw = dict(base_seed=5, ci_resamples=100)
    protocols = ("raw_model", "cds_constrained", "guided")
    assert_close(gp.summarize_by_k(samples["port"], [1, 3], protocols, **kw),
                 jax_gp.summarize_by_k(samples["jax"], [1, 3], protocols, **kw), "summary")
    records = gp.replay_records(samples["port"], stoi)
    assert records == jax_gp.replay_records(samples["jax"], stoi) and records
    path = tiny["root"] / "replay_records.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert len(GeneratedTerminationReplayDataset(path, block_size=BLOCK)) > 0


def test_audit_generated_sequences_matches_jax(tiny, tmp_path):
    training = [{"source_id": r["source_id"], "sequence": r["sequence"]}
                for r in tiny["records"][:40]]
    rng = np.random.default_rng(2)
    generated = [{"source_id": f"g{i}", "sequence": r["sequence"][: 90 + 3 * i]
                  if i % 2 else "".join(rng.choice(list("ACGT"), 120))}
                 for i, r in enumerate(tiny["records"][:8])]
    got = leakage.audit_generated_sequences(training, generated, tmp_path / "port.json",
                                            nucleotide_window=24, protein_window=8)
    want = jax_leakage.audit_generated_sequences(training, generated, tmp_path / "jax.json",
                                                 nucleotide_window=24, protein_window=8)
    assert got == want
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert got["summary"]["nucleotide"]["max"] == 1.0


def read_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


PREFIX_ARGS = ["--preset", "quick", "--max_genes", "2", "--samples", "1", "--max_new", "14",
               "--k_list", "1,4", "--ci_resamples", "60", "--min_aa_len", "4",
               "--target_aa_len", "8"]
PREFIX_PROTOCOLS = {
    "plain_with_audits": ["--nll_controls", "--memorization_n_list", "3,10"],
    "guided_synonymous": ["--target_protein", "MKVLAT", "--require_terminal_stop",
                          "--no_memorization_audit"],
}


@pytest.mark.parametrize("protocol", sorted(PREFIX_PROTOCOLS))
def test_eval_generation_prefix_cli_matches_jax(tiny, protocol, capsys):
    from genomics_lm_torch.evals.eval_generation_prefix import main as port_main
    from scripts.eval_generation_prefix import main as jax_main

    base = [str(tiny["run"]), "--npz", str(tiny["data"] / f"val_bs{BLOCK}.npz"),
            "--train_npz", str(tiny["data"] / f"train_bs{BLOCK}.npz"), *PREFIX_ARGS,
            *PREFIX_PROTOCOLS[protocol]]
    outputs = {}
    for name, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        replay = tiny["root"] / f"{protocol}_{name}.jsonl"
        label = f"{protocol}_{name}"
        assert main(base + ["--out_label", label, "--emit_replay", str(replay), *extra]) == 0
        out = tiny["run"] / "scores" / label
        outputs[name] = {
            csv_name: read_rows(out / csv_name)
            for csv_name in ("samples.csv", "protocol_samples.csv", "protocol_summary.csv",
                             "summary.csv")}
        outputs[name]["fasta"] = (out / "generated_protocols.fasta").read_text()
        outputs[name]["replay"] = replay.read_text()
        manifest = json.loads((out / "protocol_manifest.json").read_text())
        outputs[name]["manifest"] = manifest
    capsys.readouterr()
    assert_close(outputs["port"], outputs["jax"], protocol)
    rows = outputs["port"]["protocol_samples.csv"]
    assert len(rows) == 2 * 2 * (3 if protocol.startswith("guided") else 2)
    if protocol == "plain_with_audits":
        assert {"delta_shuffled", "train_overlap_3"} <= rows[0].keys()
    else:
        assert "synonymous_template" in outputs["port"]["manifest"]["protocols"]["guided"][
            "guidance_components"]


def test_replay_design_loop_and_audit_clis_match_jax(tiny, tmp_path, capsys):
    from genomics_lm_torch.data.audit_generated_sequences import main as port_audit
    from genomics_lm_torch.generation.build_generated_prefix_replay import main as port_replay
    from genomics_lm_torch.generation.generative_design_loop import main as port_design
    from scripts.audit_generated_sequences import main as jax_audit
    from scripts.build_generated_prefix_replay import main as jax_replay
    from scripts.generative_design_loop import main as jax_design

    replay_args = [str(tiny["run"]), "--npz", str(tiny["data"] / f"val_bs{BLOCK}.npz"),
                   "--n_samples", "3", "--prefix_codons", "3", "--target_codons", "4",
                   "--hard_cap", "10", "--seed", "4"]
    jax_replay(replay_args + ["--out", str(tmp_path / "jax.jsonl")])
    port_replay(replay_args + ["--out", str(tmp_path / "port.jsonl"), "--device", "cpu"])
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()

    design_args = [str(tiny["run"]), "--n_candidates", "3", "--target_codons", "3",
                   "--hard_cap", "40", "--budget", "300", "--esm_fold_top", "2",
                   "--fold_backend", "mock", "--seed", "1"]
    out = {}
    for name, main, extra in (("jax", jax_design, []), ("port", port_design,
                                                        ["--device", "cpu"])):
        assert main(design_args + ["--out_dir", str(tmp_path / name), *extra]) == 0
        summary = json.loads((tmp_path / name / "summary.json").read_text())
        summary.pop("elapsed_sec")
        report = (tmp_path / name / "report.md").read_text().splitlines()
        rows = read_rows(tmp_path / name / "candidates.csv")
        for row in rows:  # the mock fold's PDB sits in each run's own directory
            row["pdb"] = row["pdb"].replace(str(tmp_path / name), "<out>")
        out[name] = {"summary": summary, "rows": rows,
                     "report": [line for line in report if "Elapsed" not in line]}
    capsys.readouterr()
    assert_close(out["port"], out["jax"], "design loop")
    assert out["port"]["summary"]["solved"] >= 1 and out["port"]["summary"]["folded"] >= 1

    training = tmp_path / "train.tsv"
    with training.open("w") as f:
        f.write("id\tsequence\n" + "".join(f"{r['source_id']}\t{r['sequence']}\n"
                                           for r in tiny["records"][:40]))
    for name, main in (("jax", jax_audit), ("port", port_audit)):
        assert main(["--training_csv", str(training), "--generated_csv",
                     str(tmp_path / "port" / "candidates.csv"), "--nucleotide_window", "12",
                     "--out", str(tmp_path / f"audit_{name}.json")]) == 0
    assert json.loads((tmp_path / "audit_port.json").read_text()) == \
        json.loads((tmp_path / "audit_jax.json").read_text())
    capsys.readouterr()


@pytest.fixture(scope="module")
def critic_ckpts(tiny):
    """A JAX-initialized attention-pooled critic (stability a 2-class head)
    and an EBM over its latents, in the trainers' checkpoint format."""
    from genomics_lm_tpu.models import protein as jpm

    dims = {"family": 3, "function": 2, "stability": 2}
    cfg = dict(n_layer=1, n_head=2, n_embd=16, block_size=128, pooling="attention")
    # each init compiled whole: one compile instead of one per random draw
    critic = jax.jit(lambda key: jpm.init_multitask(key, jpm.ProteinClassifierConfig(
        vocab_size=28, dropout=0.0, **cfg), dims))(jax.random.PRNGKey(7))
    ebm = jax.jit(lambda key: jpm.init_ebm(key, n_embd=16, hidden_dim=8))(jax.random.PRNGKey(8))
    paths = {"critic": tiny["root"] / "critic.npz", "ebm": tiny["root"] / "ebm.npz"}
    save_checkpoint({"model": jax.tree.map(np.asarray, critic), "cfg": cfg, "task_dims": dims},
                    paths["critic"])
    save_checkpoint({"model": jax.tree.map(np.asarray, ebm)}, paths["ebm"])
    return paths


@pytest.fixture(scope="module")
def jitted_jax_critic():
    """JAX's critic scoring with its forwards compiled whole: the same
    functions, one compile per shape instead of one per primitive (the
    guided generators score a new length every step), kept for the module
    so that each shape compiles once for every case."""
    from genomics_lm_tpu.protein import critic_scoring as jcs

    with pytest.MonkeyPatch.context() as mp:
        for name in ("multitask_forward", "extract_latent"):
            mp.setattr(jcs, name, jax.jit(getattr(jcs, name), static_argnums=1))
        yield


CRITIC_CASES = {
    "critic_guidance": (["--critic_guidance", "--critic_stability"], False),
    "ebm_guidance": (["--ebm_guidance", "--ebm_ckpt", "{ebm}"], False),
    "critic_ckpt": (["--critic_stability"], True),
    "ebm_ckpt": (["--ebm_ckpt", "{ebm}", "--ebm_guidance", "--target_protein", "MKVLAT"], True),
}


@pytest.mark.parametrize("case", sorted(CRITIC_CASES))
def test_critic_flags_raise(tiny, critic_ckpts, jitted_jax_critic, case, tmp_path, capsys):
    """Each critic or EBM flag of ``eval_generation_prefix`` (all with
    ``--critic_ckpt``) gives JAX's rows; with ``--critic_ckpt`` (and
    ``--ebm_ckpt``) the design loop's candidates, critic columns and report
    equal JAX's too. The name is kept from when the port refused these flags."""
    from genomics_lm_torch.evals.eval_generation_prefix import main as port_prefix
    from genomics_lm_torch.generation.generative_design_loop import main as port_design
    from scripts.eval_generation_prefix import main as jax_prefix
    from scripts.generative_design_loop import main as jax_design

    flags, design = CRITIC_CASES[case]
    flags = ["--critic_ckpt", str(critic_ckpts["critic"])] + [
        f.format(ebm=critic_ckpts["ebm"]) for f in flags]
    base = [str(tiny["run"]), "--npz", str(tiny["data"] / f"val_bs{BLOCK}.npz"), *PREFIX_ARGS,
            "--no_memorization_audit", *flags]
    outputs = {}
    for name, main, extra in (("jax", jax_prefix, []), ("port", port_prefix,
                                                         ["--device", "cpu"])):
        label = f"critic_{case}_{name}"
        assert main(base + ["--out_label", label, *extra]) == 0
        out = tiny["run"] / "scores" / label
        outputs[name] = {csv_name: read_rows(out / csv_name)
                         for csv_name in ("samples.csv", "protocol_samples.csv",
                                          "protocol_summary.csv")}
        outputs[name]["fasta"] = (out / "generated_protocols.fasta").read_text()
        outputs[name]["manifest"] = json.loads((out / "protocol_manifest.json").read_text())
    capsys.readouterr()
    assert_close(outputs["port"], outputs["jax"], case)
    rows = outputs["port"]["protocol_samples.csv"]
    if "--critic_stability" in flags:
        assert all(np.isfinite(float(r["critic_score"])) for r in rows if r["critic_score"])
        assert any(r["critic_score"] for r in rows)
    if "--critic_guidance" in flags or "--ebm_guidance" in flags:
        components = outputs["port"]["manifest"]["protocols"]["guided"]["guidance_components"]
        assert ("ebm" if "--ebm_guidance" in flags else "critic") in components
    if not design:
        return
    design_args = [str(tiny["run"]), "--n_candidates", "3", "--target_codons", "3",
                   "--hard_cap", "40", "--budget", "300", "--esm_fold_top", "2",
                   "--fold_backend", "mock", "--seed", "1",
                   *[f for f in flags if f.endswith(".npz") or f.endswith("_ckpt")]]
    out = {}
    for name, main, extra in (("jax", jax_design, []), ("port", port_design,
                                                        ["--device", "cpu"])):
        assert main(design_args + ["--out_dir", str(tmp_path / name), *extra]) == 0
        summary = json.loads((tmp_path / name / "summary.json").read_text())
        summary.pop("elapsed_sec")
        rows = read_rows(tmp_path / name / "candidates.csv")
        for row in rows:
            row["pdb"] = row["pdb"].replace(str(tmp_path / name), "<out>")
        report = (tmp_path / name / "report.md").read_text().splitlines()
        out[name] = {"summary": summary, "rows": rows,
                     "report": [line for line in report if "Elapsed" not in line]}
    capsys.readouterr()
    assert_close(out["port"], out["jax"], f"design loop {case}")
    assert out["port"]["rows"] and all("critic_score" in r and "stability_prob" in r
                                       for r in out["port"]["rows"])
    assert "## 3. Critic scores" in out["port"]["report"]
