"""The representation benchmarks of the port against the JAX package's
scripts of the same name, on the CPU.

One tiny run (2 layers, d 64, block 64, 2 heads of 32, float32; a JAX init
written by the JAX package's checkpoint writer with its vocabulary) is read
by both packages, and the same seeded inputs (a demo-corpus gene set
labelled by GC3, random UniProt rows, embedding packs) go through each
script and the port's CLI:

- ``benchmark_gene_essentiality`` and ``benchmark_essentiality_baselines``
  (with and without the run): the reports key for key, every F1 and
  accuracy equal (the same calls on every fold), the positive fraction exact;
- ``probe_structural_awareness``, ``probe_structural_regression`` and
  ``eval_shape_baselines``: R² and Spearman ρ within ``PROBE_ATOL``;
- ``select_grouped_representation``: the selection and every candidate's
  mean and spread within ``HOST_ATOL``;
- ``probe_next_token`` with ``--npz``: the same top tokens, probabilities
  within ``PROB_ATOL``, the accuracies equal;
- ``generate_probe_labels``, ``ss_propensity``, ``disorder_heuristics``,
  ``filter_cds_by_pdb`` and ``audit_structural_motifs``: the same bytes;
- the six CLIs that run a model raise without CUDA when no ``--device`` is
  given, as the port's other entry points do.

JAX's ``forward_hidden`` is compiled once a shape for the module (the
scripts call it at batch 1 for every sequence).
"""

from __future__ import annotations

import csv
import json

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.tokenizers.codon import write_itos
from genomics_lm_tpu.training.checkpoints import save_checkpoint
from genomics_lm_torch.data.demo_corpus import main as demo_corpus
from genomics_lm_torch.evals.termination_motifs import synthetic_hairpin

BLOCK = 64
MODEL = dict(vocab_size=68, block_size=BLOCK, n_layer=2, n_head=2, n_embd=64, dropout=0.0,
             sep_id=3)
GENES = 64  # one batch of 64: one compile of JAX's pooled forward
# float32 hidden states of the two packages differ in their last bits (sums in
# another order); a ridge fit over 64 such columns moved R² and ρ by 6.9e-7 at most on
# these inputs
PROBE_ATOL = 1e-5
HOST_ATOL = 1e-9  # host float64 metrics over float32 inputs that are equal on both sides
PROB_ATOL = 2e-6  # next-token probabilities rounded to 6 decimals by both scripts


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_forward_hidden():
    """JAX's ``forward_hidden`` compiled whole for the module, one compile a
    sequence length instead of one eager dispatch per primitive a call."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gpt, "forward_hidden", jax.jit(jax_gpt.forward_hidden,
                                                      static_argnums=1))
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, and one OpenMP and BLAS thread for the scripts'
    sklearn fits, which otherwise wait on the suite's other workers."""
    from threadpoolctl import threadpool_limits

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("representation")
    run = root / "runs" / "tiny"
    (run / "checkpoints").mkdir(parents=True)
    params = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(3), JaxConfig(**MODEL)))
    save_checkpoint({"model": params, "cfg": MODEL}, run / "checkpoints" / "best.npz")
    write_itos(run / "itos.txt")

    records = root / "records.tsv"
    demo_corpus(["--out", str(records), "--genes", str(GENES), "--seed", "5",
                 "--max_codons", "80"])
    with records.open() as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    seqs = [r["sequence"] for r in rows]
    gc3 = np.asarray([np.mean([c in "GC" for c in s[5::3]]) for s in seqs])
    essential = (gc3 >= np.quantile(gc3, 0.8)).astype(int)  # the top fifth by GC3
    genes = root / "genes.csv"
    with genes.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "sequence", "essential"])
        w.writerows([r["source_id"], s, int(e)] for r, s, e in zip(rows, seqs, essential))

    rng = np.random.default_rng(9)
    X = rng.integers(4, 68, (32, BLOCK)).astype(np.int32)  # one microbatch of the probe
    X[:, 0] = 1
    Y = np.roll(X, -1, axis=1)
    Y[:, -1] = 2
    np.savez(root / "val.npz", X=X, Y=Y)
    return {"root": root, "run": run, "genes": genes, "seqs": seqs, "rows": rows,
            "val": root / "val.npz"}


def run_both(jax_main, port_main, argv, out_flag, ws, name, *, device=True):
    """The script and the port's CLI on ``argv`` plus their own ``out_flag``
    file; both JSON reports."""
    got = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        dest = ws["root"] / f"{name}_{side}.json"
        extra = ["--device", "cpu"] if side == "port" and device else []
        assert main([*argv, out_flag, str(dest), *extra]) == 0
        got[side] = json.loads(dest.read_text())
    return got["port"], got["jax"]


def close(got, want, atol, what="report"):
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            close(got[k], want[k], atol, f"{what}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, atol, f"{what}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= atol, (what, got, want)
    else:
        assert got == want and type(got) is type(want), (what, got, want)


def test_gene_essentiality_matches_jax(ws, capsys):
    from genomics_lm_torch.evals.benchmark_gene_essentiality import main as port
    from scripts.benchmark_gene_essentiality import main as jax_main

    got, want = run_both(jax_main, port, [str(ws["run"]), "--genes_csv", str(ws["genes"])],
                         "--out", ws, "essentiality")
    capsys.readouterr()
    close(got, want, 0.0)
    assert got["folds"] == 5 and got["n_genes"] == GENES and 0 < got["f1_mean"]


@pytest.mark.parametrize("with_run", [False, True], ids=["codon_freq", "with_run"])
def test_essentiality_baselines_match_jax(ws, with_run, capsys):
    from genomics_lm_torch.evals.benchmark_essentiality_baselines import main as port
    from scripts.benchmark_essentiality_baselines import main as jax_main

    argv = ([str(ws["run"])] if with_run else []) + ["--genes_csv", str(ws["genes"]),
                                                    "--folds", "4", "--seed", "2"]
    got, want = run_both(jax_main, port, argv, "--out", ws, f"baselines_{with_run}")
    capsys.readouterr()
    close(got, want, 0.0)
    assert ("lm_embedding_logreg" in got) == with_run
    assert got["codon_freq_gbdt"]["mean_f1"] > 0


@pytest.mark.parametrize("script", ["probe_structural_awareness", "probe_structural_regression",
                                    "eval_shape_baselines"])
def test_structural_probes_match_jax(ws, script, capsys):
    import importlib

    port = importlib.import_module(f"genomics_lm_torch.evals.{script}").main
    jax_main = importlib.import_module(f"scripts.{script}").main
    argv = [str(ws["run"]), "--seed", "4"]
    if script != "probe_structural_regression":
        argv += ["--n_sequences", "24"]
    got, want = run_both(jax_main, port, argv, "--out", ws, script)
    capsys.readouterr()
    close(got, want, PROBE_ATOL)
    flat = json.dumps(got)
    assert "NaN" not in flat and "Infinity" not in flat


def test_shape_baselines_without_a_run_are_jax_s(ws, capsys):
    from genomics_lm_torch.evals.eval_shape_baselines import main as port
    from scripts.eval_shape_baselines import main as jax_main

    got, want = run_both(jax_main, port, ["--n_sequences", "16"], "--out", ws, "shape_norun",
                         device=False)
    capsys.readouterr()
    close(got, want, HOST_ATOL)
    assert list(got) == ["onehot_codon", "dinucleotide_counts"]


def test_grouped_selection_matches_jax(ws, capsys):
    from genomics_lm_torch.evals.select_grouped_representation import main as port
    from scripts.select_grouped_representation import main as jax_main

    rng = np.random.default_rng(12)
    n = 90
    ids = np.asarray([f"p{i}" for i in range(n)])
    labels = rng.integers(0, 3, n)
    base = rng.normal(size=(n, 16)) + labels[:, None] * 0.4
    root = ws["root"]
    np.savez(root / "multi.npz", ids=ids, X__mean=base.astype(np.float32),
             X__eos=(base + rng.normal(size=(n, 16))).astype(np.float32))
    np.savez(root / "single.npz", ids=ids, pooling=np.asarray("mean_content"),
             X=(base * 0.5 + rng.normal(size=(n, 16))).astype(np.float32))
    with (root / "labels.csv").open("w") as f:
        f.write("id,label\n" + "".join(f"{i},{'abc'[y]}\n" for i, y in zip(ids, labels)
                                       if i != "p7"))
    with (root / "groups.tsv").open("w") as f:
        f.write("id\tprotein_cluster\n" + "".join(f"{i}\tc{int(rng.integers(0, 25))}\n"
                                                  for i in ids))
    argv = ["--embeddings", str(root / "multi.npz"), str(root / "single.npz"),
            "--labels", str(root / "labels.csv"), "--groups", str(root / "groups.tsv"),
            "--folds", "4", "--C", "0.5"]
    got, want = run_both(jax_main, port, argv, "--output", ws, "grouped", device=False)
    capsys.readouterr()
    close(got, want, HOST_ATOL)
    assert got["n_ids"] == n - 1 and len(got["candidates"]) == 3


def test_next_token_probe_matches_jax(ws, capsys):
    from genomics_lm_torch.evals.probe_next_token import main as port
    from scripts.probe_next_token import main as jax_main

    out, tables = {}, {}
    for side, main, extra in (("jax", jax_main, []), ("port", port, ["--device", "cpu"])):
        assert main([str(ws["run"]), "--npz", str(ws["val"]), *extra]) == 0
        out[side] = json.loads(capsys.readouterr().out)
        with (ws["run"] / "tables" / "next_token_probes.csv").open() as f:
            tables[side] = list(csv.DictReader(f))
    assert out["port"]["accuracy"] == out["jax"]["accuracy"]
    assert out["port"]["accuracy"]["tokens"] == 32 * BLOCK
    for got, want in ((out["port"]["prefixes"], out["jax"]["prefixes"]),
                      (tables["port"], tables["jax"])):
        assert len(got) == len(want) == 20  # 4 prefixes x top 5
        for g, w in zip(got, want):
            assert (g["prefix"], g["rank"], g["token"]) == (w["prefix"], w["rank"], w["token"])
            assert abs(float(g["prob"]) - float(w["prob"])) <= PROB_ATOL


def _same_bytes(jax_main, port, argv, paths, capsys):
    """Both CLIs on ``argv``; the files at ``paths`` byte for byte and the
    printed reports (with each side's own paths) equal."""
    got = {}
    for side, main in (("jax", jax_main), ("port", port)):
        assert main(argv(side)) == 0
        printed = capsys.readouterr().out
        got[side] = ([p(side).read_bytes() for p in paths], printed.replace(side, "SIDE"))
    assert got["port"] == got["jax"]
    return got["port"]


def test_probe_labels_are_jax_s(ws, capsys):
    from genomics_lm_torch.evals.generate_probe_labels import main as port
    from scripts.generate_probe_labels import main as jax_main

    files, _ = _same_bytes(jax_main, port, lambda side: [str(ws["run"])],
                           [lambda side: ws["run"] / "probe_labels.csv"], capsys)
    assert files[0].count(b"\n") == 69


@pytest.mark.parametrize("tool", ["ss_propensity", "disorder_heuristics"])
@pytest.mark.parametrize("source", ["dna", "protein"])
def test_protein_heuristics_are_jax_s(ws, tool, source, capsys):
    import importlib

    port = importlib.import_module(f"genomics_lm_torch.evals.{tool}").main
    jax_main = importlib.import_module(f"scripts.{tool}").main
    root = ws["root"]
    if source == "dna":
        lines = ws["seqs"][:30] + ["", "ATGNNNTAA", ws["seqs"][31][:-2]]
    else:
        from genomics_lm_torch.data.leakage import translate_cds

        lines = [translate_cds(s) for s in ws["seqs"][:30]] + ["MKKKKKKKKKKKKKKKKKK", ""]
    src = root / f"{tool}_{source}.txt"
    src.write_text("\n".join(lines) + "\n")
    outs = [lambda side: root / f"{tool}_{source}_{side}.json"]
    if tool == "ss_propensity":
        outs.append(lambda side: root / f"{tool}_{source}_{side}.csv")
    _same_bytes(jax_main, port, lambda side: [f"--{source}", str(src), "--out",
                                              str(outs[0](side))], outs, capsys)


@pytest.mark.parametrize("mode", ["uniprot", "indices"])
def test_pdb_filter_is_jax_s(ws, mode, capsys):
    from genomics_lm_torch.data.leakage import translate_cds
    from genomics_lm_torch.evals.filter_cds_by_pdb import main as port
    from scripts.filter_cds_by_pdb import main as jax_main

    root, seqs = ws["root"], ws["seqs"][:40]
    cds = root / "cds.txt"
    cds.write_text("\n".join(seqs) + "\n")
    if mode == "uniprot":
        table = root / "uniprot.tsv"
        with table.open("w") as f:
            f.write("Entry\tSequence\tKeywords\tCross-reference (PDB)\n")
            for i, s in enumerate(seqs):
                keyword = "3D-structure;Kinase" if i % 5 == 0 else "Kinase"
                pdb = "1ABC;" if i % 7 == 3 else ""
                f.write(f"P{i}\t{translate_cds(s)}\t{keyword}\t{pdb}\n")
            f.write("Q1\tMKV\t3D-structure\t\n")
        args = ["--uniprot_tsv", str(table)]
    else:
        (root / "keep.txt").write_text("3\n0\n17\n")
        args = ["--line_indices", str(root / "keep.txt")]
    files, _ = _same_bytes(
        jax_main, port,
        lambda side: ["--cds", str(cds), *args, "--out", str(root / f"kept_{mode}_{side}.txt"),
                      "--report", str(root / f"kept_{mode}_{side}.json")],
        [lambda side: root / f"kept_{mode}_{side}.txt"], capsys)
    assert files[0].count(b"\n") == (len({0, 5, 10, 15, 20, 25, 30, 35, 3, 17, 24, 31, 38})
                                     if mode == "uniprot" else 3)


def test_structural_motif_audit_is_jax_s(ws, capsys):
    from genomics_lm_torch.evals.audit_structural_motifs import main as port
    from scripts.audit_structural_motifs import main as jax_main

    motifs = ws["root"] / "motifs.json"
    motifs.write_text(json.dumps({"clusters": {
        "0": {"consensus": " ".join(synthetic_hairpin()[i:i + 3] for i in range(0, 24, 3)),
              "size": 12},
        "1": {"consensus": "ATG TTT TTT GCA", "size": 5},
        "2": {"consensus": "GCA GCA AAC", "size": 40},
        "3": {"consensus": "NNN", "size": 2}}}))
    dest = ws["run"] / "scores" / "structural_motif_audit.json"
    files, _ = _same_bytes(jax_main, port,
                           lambda side: [str(ws["run"]), "--motifs_json", str(motifs)],
                           [lambda side: dest], capsys)
    report = json.loads(files[0])
    assert report["clusters_audited"] == 3 and report["structural_clusters"] == 2


@pytest.mark.parametrize("cli,extra", [
    ("benchmark_gene_essentiality", ["--genes_csv", "GENES"]),
    ("benchmark_essentiality_baselines", ["--genes_csv", "GENES"]),
    ("probe_structural_awareness", []), ("probe_structural_regression", []),
    ("eval_shape_baselines", []), ("probe_next_token", [])])
def test_model_running_clis_default_to_the_card(ws, cli, extra, monkeypatch):
    import importlib

    main = importlib.import_module(f"genomics_lm_torch.evals.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(ws["run"]), *[str(ws["genes"]) if a == "GENES" else a for a in extra],
            "--out" if cli != "probe_next_token" else "--topk",
            str(ws["root"] / "unused.json") if cli != "probe_next_token" else "5"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
