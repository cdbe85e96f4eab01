"""PyTorch port of motif mining, the probes and their metrics against the JAX
package.

- ``evals/metrics.py::compute_metrics`` (numpy) equals JAX's (sklearn)
  within 1e-12, point estimates and bootstrap CIs: binary and multi-class
  scores, tied scores, a class absent from ``y_true`` (AUROC NaN), labels
  without the positive label 1, decision scores and ``proba`` None.
- ``evals/probes.py::fit_mlp`` from JAX's initial draw at dropout 0: the
  parameters and metrics within 1e-5 (float32 AdamW on both sides, sums in
  another order); with dropout the keep rate and the result's layout.
- ``evals/motifs.py::extract_window_embeddings`` on the einsum and the flash
  path (JAX's flash kernel in interpret mode, the port's plain version),
  int and list ``layer_idx``, strides and ``exclude_ids``: embeddings within
  1e-5 of the largest, metadata equal; clustering, consensus, PWMs and the
  known-motif matches equal from the same embeddings.
- ``termination_motifs`` and ``diversity``: equal on random DNA.
- The CLIs on one tiny run (2 layers, d 64, block 64, a JAX init written
  in the trainers' checkpoint format over a prepared demo corpus):
  ``mine_motifs``, ``benchmark_motifs``, ``check_termination_motifs``,
  ``probe_linear``, ``train_classifier`` (over ``bind_embedding_pair``) and
  ``eval_classifier`` against the JAX scripts, key for key; the embedding
  bindings accept what the port's ``extract_embeddings`` writes and refuse
  a mismatched pair as JAX's do.
"""

from __future__ import annotations

import csv
import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.evals import diversity as jax_diversity
from genomics_lm_tpu.evals import metrics as jax_metrics
from genomics_lm_tpu.evals import motifs as jax_motifs
from genomics_lm_tpu.evals import probes as jax_probes
from genomics_lm_tpu.evals import provenance as jax_provenance
from genomics_lm_tpu.evals import termination_motifs as jax_term
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_torch.data.demo_corpus import main as demo_corpus
from genomics_lm_torch.data.pipeline import prepare_dataset
from genomics_lm_torch.evals import diversity, metrics, motifs, probes, provenance
from genomics_lm_torch.evals import termination_motifs as term
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.tokenizers.codon import VOCAB, write_itos
from genomics_lm_torch.training.checkpoints import save_checkpoint
from genomics_lm_torch.utils.weights import params_from_jax

METRIC_TOL = 1e-12  # float64 numpy against sklearn's float64 arithmetic
TOL = 1e-5  # float32 forwards and AdamW steps whose sums differ only in order
BLOCK = 64
MODEL = dict(vocab_size=68, block_size=BLOCK, n_layer=2, n_head=2, n_embd=64, dropout=0.0,
             sep_id=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_rel(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)
    assert err <= tol, f"{what}: {err} > {tol}"


def assert_same_metrics(got: dict, want: dict, tol: float):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if np.isnan(value):
            assert np.isnan(got[key]), key
        else:
            assert abs(got[key] - value) <= tol, (key, got[key], value)


# --- metrics -----------------------------------------------------------------


def metric_case(name: str):
    rng = np.random.default_rng(METRIC_CASES.index(name))
    n = 60
    y = rng.integers(0, 2, n)
    pred = rng.integers(0, 2, n)
    if name == "binary_1d":
        return y, pred, rng.random(n)
    if name == "binary_2d":
        p = rng.random(n)
        return y, pred, np.stack([1 - p, p], axis=1)
    y, pred = rng.integers(0, 4, n), rng.integers(0, 4, n)
    logits = rng.normal(size=(n, 4))
    softmax = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    if name == "multiclass":
        return y, pred, softmax
    if name == "tied_scores":
        return y, pred, np.round(softmax, 1)
    if name == "class_absent":  # class 2 never true, but predicted and scored
        y = np.where(y == 2, 0, y)
        return y, pred, softmax
    if name == "one_class":
        return np.zeros(n, np.int64), pred % 2, rng.random(n)
    if name == "labels_without_one":  # binary labels {0, 2}: no AUPRC
        y = 2 * rng.integers(0, 2, n)
        return y, y, np.round(rng.random(n), 1)
    if name == "decision_scores":
        return y, pred, logits * 3
    if name == "proba_none":
        return y, pred, None
    raise KeyError(name)


METRIC_CASES = ["binary_1d", "binary_2d", "multiclass", "tied_scores", "class_absent",
                "one_class", "labels_without_one", "decision_scores", "proba_none"]


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("name", METRIC_CASES)
def test_compute_metrics_matches_jax(name):
    y, pred, proba = metric_case(name)
    for kw in ({}, dict(bootstrap=True, n_resamples=200, seed=7)):
        want = jax_metrics.compute_metrics(y, pred, proba, **kw)
        got = metrics.compute_metrics(y, pred, proba, **kw)
        assert_same_metrics(got, want, METRIC_TOL)
        if kw:
            assert {f"accuracy_ci_{s}" for s in ("lower", "upper")} <= got.keys()
    if name == "class_absent":
        assert np.isnan(got["auroc"]) and np.isfinite(got["macro_auprc"])
    if name == "labels_without_one":
        assert "auroc" in got and "macro_auprc" not in got


def test_confusion_and_calibration_numbers_match_sklearn(tmp_path, capsys):
    from sklearn.calibration import calibration_curve
    from sklearn.metrics import confusion_matrix

    rng = np.random.default_rng(3)
    y, pred = rng.integers(0, 4, 80), rng.integers(1, 5, 80)
    classes, matrix = metrics.confusion_matrix(y, pred)
    want = confusion_matrix(y, pred, labels=classes, normalize="true")
    np.testing.assert_allclose(matrix, want, rtol=0, atol=1e-15)
    hits, conf = rng.integers(0, 2, 80), rng.random(80)
    frac, mean = metrics.calibration_bins(hits, conf, 10)
    want_frac, want_mean = calibration_curve(hits, conf, n_bins=10)
    np.testing.assert_allclose(frac, want_frac, atol=1e-15)
    np.testing.assert_allclose(mean, want_mean, atol=1e-15)
    metrics.plot_confusion(y, pred, tmp_path / "confusion.png")
    metrics.plot_calibration(y % 2, conf, tmp_path / "calibration.png")
    assert (tmp_path / "confusion.png").is_file() and (tmp_path / "calibration.png").is_file()


# --- the MLP probe -----------------------------------------------------------


def jax_init(dims, seed):
    """JAX ``fit_mlp``'s initial draw, handed to the port's helper."""
    key, out = jax.random.PRNGKey(seed), []
    for a, b in zip(dims[:-1], dims[1:]):
        key, sub = jax.random.split(key)
        bound = 1.0 / np.sqrt(a)
        out.append({"w": np.asarray(jax.random.uniform(sub, (a, b), jnp.float32, -bound, bound)),
                    "b": np.zeros((b,), np.float32)})
    return out


def probe_data(seed=0, n=90, d=16, classes=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, :classes].argmax(axis=1) + (rng.random(n) < 0.2)) % classes
    return X, y


def test_fit_mlp_from_jax_init_matches_jax(monkeypatch):
    X, y = probe_data()
    kw = dict(epochs=3, hidden=32, depth=2, dropout=0.0, seed=4, batch_size=16, lr=3e-3)
    want = jax_probes.fit_mlp(X, y, **kw)
    monkeypatch.setattr(probes, "init_mlp_layers", jax_init)
    got = probes.fit_mlp(X, y, device="cpu", **kw)
    assert len(got.params) == len(want.params) == 3
    for g, w in zip(got.params, want.params):
        for key in ("w", "b"):
            assert_rel(g[key], np.asarray(w[key]), f"param {key}")
    assert_same_metrics(got.metrics, want.metrics, TOL)
    np.testing.assert_array_equal(got.y_pred, want.y_pred)
    assert_rel(got.y_proba, want.y_proba, "proba")
    X_new = np.random.default_rng(9).normal(size=(20, 16)).astype(np.float32)
    labels, proba = got.predict_fn(X_new)
    want_labels, want_proba = want.predict_fn(X_new)
    np.testing.assert_array_equal(labels, want_labels)
    assert_rel(proba, want_proba, "predict_fn proba")


def test_fit_mlp_dropout_keeps_its_rate_and_layout():
    x = torch.ones(256, 4096)
    out = probes.dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert abs(float((out == 0).float().mean()) - 0.3) < 0.005
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.7))
    head = probes.MLPHead(probes.init_mlp_layers([8, 256, 2], 0), dropout=0.3)
    x = torch.ones(16, 8)
    torch.testing.assert_close(head(x, torch.Generator().manual_seed(5)),
                               head(x, torch.Generator().manual_seed(5)))
    assert not torch.allclose(head(x, torch.Generator().manual_seed(5)), head(x))

    X, y = probe_data(1)
    got = probes.fit_mlp(X, y, epochs=2, hidden=16, dropout=0.2, seed=1, device="cpu")
    want = jax_probes.fit_mlp(X, y, epochs=2, hidden=16, dropout=0.2, seed=1)
    assert got.metrics.keys() == want.metrics.keys()
    assert [{k: v.shape for k, v in p.items()} for p in got.params] == \
        [{k: np.asarray(v).shape for k, v in p.items()} for p in want.params]
    assert got.y_proba.shape == want.y_proba.shape and got.y_pred.shape == want.y_pred.shape


# --- window embeddings and motif mining -----------------------------------------


def window_rows(seed=0, rows=3):
    """Rows of codon ids with <SEP> segments and a PAD tail."""
    rng = np.random.default_rng(seed)
    x = rng.integers(4, 68, (rows, BLOCK)).astype(np.int32)
    x[:, 0] = 1
    x[:, 29] = 3
    x[1, -10:] = 0
    return x


def model_pair(impl="xla", seed=1):
    kw = dict(MODEL, attention_impl=impl)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    return params, jcfg, params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"), tcfg


EMBED_CASES = {
    "einsum_last_layer": ("xla", -1, 1, None),
    "einsum_two_layers_stride2_no_pad": ("xla", [0, -1], 2, [0]),
    "flash_exclude_pad_and_sep": ("flash", -1, 1, [0, 3]),
    "flash_layer_list_stride3": ("flash", [1], 3, None),
}


@pytest.mark.parametrize("case", sorted(EMBED_CASES))
def test_window_embeddings_match_jax(case):
    impl, layer_idx, stride, exclude = EMBED_CASES[case]
    params, jcfg, model, tcfg = model_pair(impl)
    x = window_rows()
    kw = dict(window_size=9, stride=stride, layer_idx=layer_idx, exclude_ids=exclude)
    want, want_meta = jax_motifs.extract_window_embeddings(params, jcfg, x, **kw)
    got, meta = motifs.extract_window_embeddings(model, tcfg, x, **kw)
    assert meta == want_meta and len(meta) > 0
    assert got.dtype == np.float32
    assert_rel(got, want, case)


def test_window_embeddings_with_every_window_excluded():
    params, jcfg, model, tcfg = model_pair()
    x = np.zeros((2, BLOCK), np.int32)
    want, want_meta = jax_motifs.extract_window_embeddings(params, jcfg, x, exclude_ids=[0])
    got, meta = motifs.extract_window_embeddings(model, tcfg, x, exclude_ids=[0])
    assert meta == want_meta == [] and got.shape == want.shape == (0, MODEL["n_embd"])


@pytest.mark.parametrize("method,pca", [("kmeans", None), ("kmeans", 3), ("hdbscan", None)])
def test_clustering_consensus_and_pwm_equal_jax(method, pca):
    _, _, model, tcfg = model_pair()
    x = window_rows(4)
    emb, meta = motifs.extract_window_embeddings(model, tcfg, x, exclude_ids=[0])
    itos = dict(enumerate(VOCAB))
    jc = jax_motifs.MotifClusterer(method=method, n_clusters=4, pca_components=pca)
    tc = motifs.MotifClusterer(method=method, n_clusters=4, pca_components=pca)
    labels = tc.fit_predict(emb)
    np.testing.assert_array_equal(labels, jc.fit_predict(emb))
    np.testing.assert_array_equal(tc.get_centers(emb), jc.get_centers(emb))
    assert motifs.cluster_consensus(x, meta, labels, itos) == \
        jax_motifs.cluster_consensus(x, meta, labels, itos)
    assert motifs.cluster_pwm_report(x, meta, labels, itos) == \
        jax_motifs.cluster_pwm_report(x, meta, labels, itos)
    seqs = [["ATG", "AAA", "TAA"], ["ATG", "GGG", "TAA"], ["CCC", "AAA", "XYZ"]]
    vocab = ["AAA", "ATG", "CCC", "GGG", "TAA"]
    pwm = motifs.position_weight_matrix(seqs, vocab)
    np.testing.assert_array_equal(pwm, jax_motifs.position_weight_matrix(seqs, vocab))
    assert motifs.pwm_consensus(pwm, vocab, " ") == jax_motifs.pwm_consensus(pwm, vocab, " ")
    np.testing.assert_array_equal(motifs.pwm_information_content(pwm, 5),
                                  jax_motifs.pwm_information_content(pwm, 5))
    for text in ("AGG AGG TAT AAT", "TTT TTT ATG", "GCC"):
        assert motifs.match_known_motifs(text) == jax_motifs.match_known_motifs(text)
    assert motifs.KNOWN_MOTIFS == jax_motifs.KNOWN_MOTIFS


def random_dna(rng, n, lo=40, hi=200):
    return ["".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))) for _ in range(n)]


def test_termination_motifs_and_diversity_equal_jax():
    rng = np.random.default_rng(5)
    dna = random_dna(rng, 12) + ["ATG" + term.synthetic_hairpin() * 4]
    assert term.terminal_window_contrast(dna, window=30, seed=3) == \
        jax_term.terminal_window_contrast(dna, window=30, seed=3)
    for s in dna[:4]:
        assert term.hairpin_score(s[:40]) == jax_term.hairpin_score(s[:40])
        assert term.max_poly_t_run(s) == jax_term.max_poly_t_run(s)
        assert term.gc_fraction(s) == jax_term.gc_fraction(s)
    assert term.synthetic_hairpin("GGCC", "TTT") == jax_term.synthetic_hairpin("GGCC", "TTT")
    aa = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(rng.integers(5, 40))))
          for _ in range(9)]
    for kw in ({}, dict(max_pairs=5, seed=2)):
        assert diversity.pairwise_identity(aa, **kw) == jax_diversity.pairwise_identity(aa, **kw)
    assert diversity.kmer_diversity(aa, k=2) == jax_diversity.kmer_diversity(aa, k=2)
    codons = [[s[i:i + 3] for i in range(0, len(s) - 2, 3)] for s in dna]
    assert diversity.gc_content(codons + [[]]) == jax_diversity.gc_content(codons + [[]])


# --- the CLIs ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A prepared demo corpus (block 64) and a run directory holding a JAX init
    in the trainers' checkpoint format, its config bound to the dataset id."""
    root = tmp_path_factory.mktemp("motif_run")
    demo_corpus(["--out", str(root / "records.tsv"), "--genes", "60", "--seed", "2",
                 "--min_codons", "30", "--max_codons", "100"])
    with (root / "records.tsv").open() as f:
        records = list(csv.DictReader(f, delimiter="\t"))
    data = root / "dataset"
    manifest = prepare_dataset(records, data, block_size=BLOCK, split_seed=2,
                               skip_homology=True)
    run = root / "runs" / "tiny"
    (run / "checkpoints").mkdir(parents=True)
    params = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(3), JaxConfig(**MODEL)))
    cfg = dict(MODEL, dataset_manifest={"dataset_id": manifest["dataset"]["id"]})
    save_checkpoint({"model": params, "cfg": cfg}, run / "checkpoints" / "best.npz")
    write_itos(run / "itos.txt")
    return {"run": run, "data": data, "records": records}


def run_cli(main, argv) -> None:
    assert main(argv) in (0, None)


def test_mine_and_benchmark_motifs_clis_match_jax(tiny, tmp_path, capsys):
    from genomics_lm_torch.evals.benchmark_motifs import main as port_bench
    from genomics_lm_torch.evals.mine_motifs import main as port_mine
    from scripts.benchmark_motifs import main as jax_bench
    from scripts.mine_motifs import main as jax_mine

    argv = [str(tiny["run"]), "--npz", str(tiny["data"] / f"train_bs{BLOCK}.npz"),
            "--max_windows", "6", "--n_clusters", "5"]
    run_cli(jax_mine, argv + ["--out", str(tmp_path / "jax.json")])
    run_cli(port_mine, argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == want and got["n_clusters"] == 5 and got["n_windows"] > 100
    benchmarks = []
    for main, mined in ((jax_bench, "jax.json"), (port_bench, "port.json")):
        run_cli(main, [str(tiny["run"]), "--motifs_json", str(tmp_path / mined)])
        benchmarks.append(json.loads((tiny["run"] / "scores" / "motif_benchmark.json")
                                     .read_text()))
    assert benchmarks[0] == benchmarks[1] and benchmarks[1]["clusters"] == 5
    assert "[motifs]" in capsys.readouterr().out


def test_check_termination_motifs_cli_matches_jax(tiny, tmp_path):
    from genomics_lm_torch.evals.check_termination_motifs import main as port_check
    from scripts.check_termination_motifs import main as jax_check

    (tmp_path / "real.txt").write_text("\n".join(r["sequence"] for r in tiny["records"][:20]))
    with (tmp_path / "generated.csv").open("w") as f:
        f.write("candidate,dna\n" + "".join(f"{i},{r['sequence'][::-1]}\n"
                                            for i, r in enumerate(tiny["records"][20:30])))
    reports = []
    for main in (jax_check, port_check):
        out = tmp_path / f"{main.__module__}.json"
        run_cli(main, ["--dna", str(tmp_path / "real.txt"), "--generated",
                       str(tmp_path / "generated.csv"), "--window", "24", "--seed", "4",
                       "--out", str(out)])
        reports.append(json.loads(out.read_text()))
    assert reports[0] == reports[1] and reports[1]["generated"]["sequences_scored"] == 10


@pytest.fixture(scope="module")
def packs(tiny, tmp_path_factory):
    """Train and test embedding packs written by the port's ``extract_embeddings``
    with the manifest (verified sidecars), and their genus labels."""
    from genomics_lm_torch.evals.extract_embeddings import main as extract

    root = tmp_path_factory.mktemp("packs")
    genera = sorted({r["genus"] for r in tiny["records"]})
    with (root / "labels.csv").open("w") as f:
        f.write("id,label\n" + "".join(f"{r['source_id']},{genera.index(r['genus'])}\n"
                                       for r in tiny["records"]))
    out = {}
    for name, rows in (("train", tiny["records"][:36]), ("test", tiny["records"][36:56])):
        fasta = root / f"{name}.fasta"
        fasta.write_text("".join(f">{r['source_id']}\n{r['sequence']}\n" for r in rows))
        out[name] = root / f"{name}.npz"
        run_cli(extract, [str(tiny["run"]), "--input", str(fasta), "--out", str(out[name]),
                          "--dataset_manifest", str(tiny["data"] / "manifest.json"),
                          "--device", "cpu"])
    out["labels"] = root / "labels.csv"
    return out


def test_embedding_bindings_accept_the_ports_packs_and_refuse_as_jax(packs, tmp_path):
    for verified in (False, True):
        got = provenance.bind_embedding_pair(packs["train"], packs["test"],
                                             require_verified=verified)
        want = jax_provenance.bind_embedding_pair(packs["train"], packs["test"],
                                                  require_verified=verified)
        assert got == want
    assert got["train"]["status"] == "verified_embedding"
    # a test pack from another dataset id: refused by both, with one message
    other = tmp_path / "other.npz"
    other.write_bytes(packs["test"].read_bytes())
    sidecar = json.loads(packs["test"].with_suffix(".provenance.json").read_text())
    sidecar["dataset_manifest"]["dataset_id"] = "another-dataset"
    other.with_suffix(".provenance.json").write_text(json.dumps(sidecar))
    bare = tmp_path / "bare.npz"  # no sidecar at all
    bare.write_bytes(packs["test"].read_bytes())
    for test_pack in (other, bare):
        with pytest.raises(jax_provenance.EvaluationProvenanceError) as want:
            jax_provenance.bind_embedding_pair(packs["train"], test_pack, require_verified=True)
        with pytest.raises(provenance.EvaluationProvenanceError) as got:
            provenance.bind_embedding_pair(packs["train"], test_pack, require_verified=True)
        assert str(got.value) == str(want.value)
    assert provenance.bind_embedding_pair(packs["train"], bare, require_verified=False)[
        "test"]["status"] == "legacy_embedding_unverified"


@pytest.mark.filterwarnings("ignore")
def test_probe_and_classifier_clis_match_jax(packs, tmp_path, capsys, monkeypatch):
    from genomics_lm_torch.evals.eval_classifier import main as port_eval
    from genomics_lm_torch.evals.probe_linear import main as port_probe
    from genomics_lm_torch.evals.train_classifier import main as port_train
    from scripts.eval_classifier import main as jax_eval
    from scripts.probe_linear import main as jax_probe
    from scripts.train_classifier import main as jax_train

    # the CLIs' bootstrap at 200 resamples on both sides instead of 1,000: the
    # JAX side scores each resample through sklearn's metrics, which took most
    # of this test's time; the bootstrap itself is held to JAX's at 200
    # resamples in test_compute_metrics_matches_jax
    for module in (jax_metrics, metrics):
        monkeypatch.setattr(module, "compute_metrics",
                            functools.partial(module.compute_metrics, n_resamples=200))

    labels = str(packs["labels"])
    probe = {}
    for name, main in (("jax", jax_probe), ("port", port_probe)):
        run_cli(main, ["--train_npz", str(packs["train"]), "--test_npz", str(packs["test"]),
                       "--train_labels", labels, "--test_labels", labels, "--kind", "svm",
                       "--out", str(tmp_path / f"probe_{name}.json")])
        probe[name] = json.loads((tmp_path / f"probe_{name}.json").read_text())
    assert probe["port"] == probe["jax"]

    reports = {}
    for kind, name, main, extra in (("probe_logreg", "jax", jax_train, []),
                                    ("probe_logreg", "port", port_train, ["--device", "cpu"]),
                                    ("mlp", "port", port_train, ["--device", "cpu"])):
        out = tmp_path / f"{kind}_{name}"
        config = tmp_path / f"{kind}_{name}.yaml"
        config.write_text(json.dumps(dict(
            kind=kind, protocol="TRTS", train_npz=str(packs["train"]),
            test_npz=str(packs["test"]), train_labels=labels, test_labels=labels,
            require_verified_provenance=True, epochs=2, hidden=16)))
        run_cli(main, ["--config", str(config), "--out_dir", str(out), *extra])
        reports[kind, name] = json.loads((out / "metrics.json").read_text())
    assert reports["probe_logreg", "port"] == reports["probe_logreg", "jax"]
    assert reports["probe_logreg", "port"]["provenance"] == {"train": "verified_embedding",
                                                            "test": "verified_embedding"}
    # the mlp kind trains at dropout 0.1, whose keep bits come from another
    # generator in each package (fit_mlp itself is held to JAX at dropout 0
    # above): its report has the layout of the JAX logreg report (both score
    # a (n, classes) probability)
    got, want = reports["mlp", "port"], reports["probe_logreg", "jax"]
    assert got.keys() == want.keys() and got["kind"] == "mlp"
    for key in ("train_metrics", "test_metrics"):
        assert got[key].keys() == want[key].keys()
    assert {k: got[k] for k in ("protocol", "n_train", "n_test", "provenance")} == \
        {k: want[k] for k in ("protocol", "n_train", "n_test", "provenance")}

    evaluated = {}
    for name, main in (("jax", jax_eval), ("port", port_eval)):
        run_cli(main, ["--kind", "probe", "--model",
                       str(tmp_path / f"probe_logreg_{name}" / "model.pkl"),
                       "--embeddings", str(packs["test"]), "--labels", labels,
                       "--out", str(tmp_path / f"eval_{name}")])
        evaluated[name] = json.loads((tmp_path / f"eval_{name}" / "metrics.json").read_text())
    assert evaluated["port"] == evaluated["jax"] and "auroc" in evaluated["port"]
    with (tmp_path / "probe_logreg_port" / "model.pkl").open("rb") as f:
        assert type(pickle.load(f)).__name__ == "Pipeline"
    capsys.readouterr()
