"""PyTorch port of the dashboard data layer, the analysis steps 5-6, the
run summaries and their CLIs against the JAX package on the CPU.

One tiny run (2 layers, d 32, block 32, trained one epoch by the port,
with ``<SEP>`` segments) and two runs derived from its checkpoint (under
``attention_impl="flash"``, and a 2-expert top-2 MoE from a JAX init)
serve both packages. Tolerances: tables, series, summaries and shape
profiles EXACT (the same files, the same float64 arithmetic); generated
tokens equal from one seed; next-codon probabilities, attention maps and
embeddings within 1e-5 (float32 forwards whose sums differ only in order);
saliency within 1e-5 of its largest entry (a float32 gradient); the PCA
equal to sklearn's within 1e-6 on the same matrix.
"""

from __future__ import annotations

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu import dashboard as jax_dash
from genomics_lm_tpu.evals import analysis as jax_analysis
from genomics_lm_tpu.evals import summaries as jax_summaries
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_torch import dashboard
from genomics_lm_torch.evals import analysis, summaries
from genomics_lm_torch.evals.export_run_summary import main as export_cli
from genomics_lm_torch.evals.generate_run_summaries import main as summaries_cli
from genomics_lm_torch.evals.run_analysis import main as analysis_cli
from genomics_lm_torch.evals.visualizer import pca_2d
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training.checkpoints import load_checkpoint, save_checkpoint
from genomics_lm_torch.training.loop import run_training

ATOL = 1e-5
PCA_ATOL = 1e-6
BLOCK = 32
PROBE = "ATGAAACCCGGGTTT"  # the analysis default: T 6 with BOS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_close(got, want, what, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1.0)
    assert err <= atol, f"{what}: {err} > {atol}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs/tiny`` (trained), ``runs/tiny-flash`` and ``runs/tiny-moe``
    (checkpoint and vocabulary only), and the validation split."""
    root = tmp_path_factory.mktemp("dashboard")
    rng = np.random.default_rng(1)
    succ = rng.integers(4, 68, (68, 3))
    for name, n in (("train", 24), ("val", 10)):
        X = np.zeros((n, BLOCK), np.int32)
        X[:, 0] = 1
        for t in range(1, BLOCK):
            X[:, t] = succ[X[:, t - 1], rng.integers(0, 3, n)]
        X[:, 13::17] = 3
        Y = np.roll(X, -1, axis=1)
        Y[:, -1] = 2
        np.savez(root / f"{name}.npz", X=X, Y=Y)
    write_itos(root / "itos.txt")
    cfg = dict(train_npz=str(root / "train.npz"), val_npz=str(root / "val.npz"),
               block_size=BLOCK, n_layer=2, n_head=2, n_embd=32, dropout=0.0, batch_size=8,
               grad_accum_steps=1, lr=3e-3, warmup_steps=1, epochs=1, seed=0,
               early_stop_patience=0, run_id="tiny")
    torch.manual_seed(0)
    run_training(cfg, run_root=str(root / "runs"), device="cpu", progress_every=0)
    tiny = root / "runs" / "tiny"
    payload = load_checkpoint(tiny / "checkpoints" / "best.npz")
    flash = root / "runs" / "tiny-flash"
    save_checkpoint(dict(payload, cfg=dict(payload["cfg"], attention_impl="flash")),
                    flash / "checkpoints" / "best.npz")
    moe = root / "runs" / "tiny-moe"
    moe_cfg = dict(payload["cfg"], moe_experts=2, moe_top_k=2, vocab_size=68)
    params = jax_gpt.init(jax.random.PRNGKey(3), JaxConfig.from_run_config(moe_cfg))
    save_checkpoint({"model": jax.tree_util.tree_map(np.asarray, params), "cfg": moe_cfg},
                    moe / "checkpoints" / "best.npz")
    for d in (flash, moe):
        shutil.copy(tiny / "itos.txt", d / "itos.txt")
    return {"root": root / "runs", "tiny": tiny, "flash": flash, "moe": moe,
            "val": root / "val.npz"}


def test_browser_and_details_equal_jax(runs):
    assert dashboard.run_browser_data(runs["root"]) == jax_dash.run_browser_data(runs["root"])
    got = dashboard.run_details_data(runs["tiny"])
    assert got == jax_dash.run_details_data(runs["tiny"])
    assert got["series"]["epoch"] == [1.0] and got["run"]["complete"]
    assert dashboard.run_browser_data(runs["root"] / "missing") == {"runs": [], "table": []}


@pytest.mark.parametrize("run", ["tiny", "moe"])
def test_playground_pages_match_jax(runs, run):
    got = dashboard.playground_next_codon(runs[run], "ATGAAACCCG", top_k=8, device="cpu")
    want = jax_dash.playground_next_codon(runs[run], "ATGAAACCCG", top_k=8)
    assert (got["prompt"], got["context_tokens"]) == (want["prompt"], want["context_tokens"])
    assert [r["token"] for r in got["next"]] == [r["token"] for r in want["next"]]
    assert_close([r["prob"] for r in got["next"]], [r["prob"] for r in want["next"]],
                 "next-codon probabilities")
    for seed in (0, 5):
        got = dashboard.playground_generate(runs[run], "ATGAAA", target_codons=8, hard_cap=20,
                                            seed=seed, device="cpu")
        want = jax_dash.playground_generate(runs[run], "ATGAAA", target_codons=8, hard_cap=20,
                                            seed=seed)
        assert got["ids"] == [int(t) for t in want["ids"]] and got["dna"] == want["dna"]
        assert got["info"] == want["info"]


@pytest.mark.parametrize("run", ["tiny", "moe"])
def test_attention_and_embeddings_match_jax(runs, run):
    for layer in (-1, 0):
        got = dashboard.attention_data(runs[run], "ATGAAACCCGGGTAA", layer=layer, device="cpu")
        want = jax_dash.attention_data(runs[run], "ATGAAACCCGGGTAA", layer=layer)
        assert (got["tokens"], got["n_layers"]) == (want["tokens"], want["n_layers"])
        assert_close(got["attention"], want["attention"], f"attention layer {layer}")
    seqs = ["ATGAAACCCGGGTAA", "ATGTTTGATCTGAAATAG", "ATGCCCCCCAAAGGGTTTTGA", "ATGGCTTAA"]
    got = dashboard.embeddings_data(runs[run], seqs, device="cpu")
    want = jax_dash.embeddings_data(runs[run], seqs)
    assert_close(got["embeddings"], want["embeddings"], "pooled embeddings")
    assert_close(got["pca"], want["pca"], "PCA coordinates of the embeddings")
    assert dashboard.embeddings_data(runs[run], seqs[:1], device="cpu")["pca"] is None


def test_pca_equals_sklearn():
    from sklearn.decomposition import PCA

    rng = np.random.default_rng(9)
    for n, d, k in ((4, 32, 2), (30, 8, 2), (200, 12, 2), (5, 1, 1)):
        X = rng.normal(size=(n, d)) * rng.uniform(0.1, 3.0, d)
        want = PCA(n_components=k).fit_transform(X)
        np.testing.assert_allclose(pca_2d(X), want, rtol=0, atol=PCA_ATOL)


@pytest.mark.parametrize("run", ["tiny", "flash", "moe"])
@pytest.mark.parametrize("dna", [PROBE, "ATGAAATAACCCGGGTTTAAAGGGCCC"])
def test_saliency_matches_jax(runs, run, dna):
    """The gradient of the top logit through the inference blocks: einsum
    attention, the flash path (the port's plain versions of the forward,
    dQ and dK/dV on the CPU; JAX falls back to its einsum path off the
    block grid), and a MoE run routed dropless."""
    got = dashboard.saliency_data(runs[run], dna, device="cpu")
    want = jax_dash.saliency_data(runs[run], dna)
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 1 + len(dna) // 3
    assert np.all(np.asarray(got["saliency"]) > 0)
    assert_close(got["saliency"], want["saliency"], f"saliency ({run})")


def test_shape_profiles_are_exact():
    wt, var = "ATGAAAAAAGGGTTTTAA", "ATGCGCGCGGGCTTCTAG"
    assert dashboard.shape_profile_data(wt) == jax_dash.shape_profile_data(wt)
    got = dashboard.shape_comparison_data(wt, var)
    assert got == jax_dash.shape_comparison_data(wt, var)
    assert got["aligned_length"] == 18 and got["mean_abs_delta_MGW"] > 0


def test_full_analysis_matches_jax(runs, tmp_path):
    dirs = {side: tmp_path / side for side in ("port", "jax")}
    for d in dirs.values():
        shutil.copytree(runs["tiny"], d)
    got = analysis.run_full_analysis(dirs["port"], runs["val"], device="cpu")
    want = jax_analysis.run_full_analysis(dirs["jax"], runs["val"])
    assert got.keys() == want.keys() == {"frequencies", "embeddings", "attention",
                                         "next_token_probe", "saliency"}
    for step in ("frequencies", "embeddings", "attention"):
        assert got[step] == want[step], step
    for key, value in want["next_token_probe"].items():
        assert got["next_token_probe"][key] == pytest.approx(value, abs=ATOL)
    assert got["saliency"]["positions"] == want["saliency"]["positions"] == 6
    top, jtop = got["saliency"]["top"], want["saliency"]["top"]
    assert (top["position"], top["token"]) == (jtop["position"], jtop["token"])
    assert top["saliency"] == pytest.approx(jtop["saliency"], rel=ATOL)
    rows = [json.loads((d / "tables" / "saliency.json").read_text()) for d in dirs.values()]
    assert_close([r["saliency"] for r in rows[0]], [r["saliency"] for r in rows[1]], "saliency")
    for d in dirs.values():
        summary = json.loads((d / "tables" / "run_summary.json").read_text())
        assert summary["analysis"].keys() == got.keys()
        assert (d / "tables" / "run_summary.md").read_text().startswith("# Analysis summary")


def test_summaries_are_byte_equal(runs, tmp_path):
    roots = {side: tmp_path / side for side in ("port", "jax")}
    for root in roots.values():
        shutil.copytree(runs["root"], root)
    md = summaries.generate_summary(roots["port"])
    assert md == roots["port"] / "summary.md"
    jax_summaries.generate_summary(roots["jax"])
    for name in ("summary.md", "_summary/summary.csv"):
        assert (roots["port"] / name).read_bytes() == (roots["jax"] / name).read_bytes(), name
    assert "| tiny | completed |" in md.read_text()
    # the trainer refreshed it beside the run's checkpoints, as JAX's does
    assert (runs["tiny"] / "summary.md").exists()
    assert (runs["tiny"] / "_summary" / "summary.csv").exists()
    empty = tmp_path / "empty"
    empty.mkdir()
    summaries.generate_summary(empty)
    assert (empty / "summary.md").read_text() == "# Run summary\n\n_no runs found_\n"


def test_summary_and_analysis_clis_match_jax(runs, tmp_path, capsys):
    from scripts.export_run_summary import main as jax_export
    from scripts.generate_run_summaries import main as jax_summaries_cli

    assert summaries_cli(["--run_root", str(runs["root"]), "--out", str(tmp_path / "p.csv")]) == 0
    jax_summaries_cli(["--run_root", str(runs["root"]), "--out", str(tmp_path / "j.csv")])
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert json.loads(capsys.readouterr().out.split("}\n")[0] + "}")["runs"] == 3
    run = tmp_path / "run"
    shutil.copytree(runs["tiny"], run)
    assert analysis_cli([str(run), "--val_npz", str(runs["val"]), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert json.loads(printed)["saliency"]["positions"] == 6
    assert export_cli([str(run)]) == 0
    port = json.loads(capsys.readouterr().out)
    jax_export([str(run)])
    assert json.loads(capsys.readouterr().out) == port
    assert {"frequencies", "next_token_probe", "saliency"} <= set(port["sections"])


class _FakeTab:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _FakeStreamlit:
    """Records every render call; buttons return True and inputs their
    defaults, so ``main()`` runs every tab's branch against the data layer."""

    def __init__(self, text_overrides=None):
        self.calls = []
        self.text_overrides = dict(text_overrides or {})
        self.sidebar = self

    def _record(self, name, *args, **kwargs):
        self.calls.append((name, args, kwargs))

    def names(self):
        return [c[0] for c in self.calls]

    def text_input(self, label, value=""):
        self._record("text_input", label)
        return self.text_overrides.get(label, value)

    text_area = text_input

    def number_input(self, label, value=0):
        self._record("number_input", label)
        return value

    def button(self, label):
        self._record("button", label)
        return True

    def selectbox(self, label, options):
        self._record("selectbox", label, tuple(options))
        return options[0]

    def tabs(self, labels):
        self._record("tabs", tuple(labels))
        return [_FakeTab() for _ in labels]

    def __getattr__(self, name):
        def sink(*args, **kwargs):
            self._record(name, *args, **kwargs)

        return sink


def test_web_dashboard_renders_every_tab(runs, tmp_path, monkeypatch):
    import sys

    from genomics_lm_torch import web_dashboard

    fake = _FakeStreamlit({"DNA prompt": "ATGAAACCCGGG",
                           "synonymous variant (optional)": "ATGAAACCAGGG"})
    monkeypatch.setitem(sys.modules, "streamlit", fake)
    monkeypatch.chdir(runs["root"].parent)  # the renderer reads runs/ under the cwd
    web_dashboard.main(device="cpu")
    names = fake.names()
    assert "set_page_config" in names and "title" in names
    tabs = next(c for c in fake.calls if c[0] == "tabs")
    assert tabs[1][0] == ("overview", "curves", "playground", "attention", "saliency",
                          "embeddings")
    payloads = [c[1][0] for c in fake.calls if c[0] == "json" and isinstance(c[1][0], dict)]
    assert any("next" in p for p in payloads)
    assert any("dna" in p and "info" in p for p in payloads)
    assert any("mean_abs_delta_MGW" in p for p in payloads)
    assert any(c[1] and c[1][0] == "tokens:" for c in fake.calls if c[0] == "write")
    for chart in ("line_chart", "bar_chart", "scatter_chart", "dataframe"):
        assert chart in names, chart
    empty = _FakeStreamlit()
    monkeypatch.setitem(sys.modules, "streamlit", empty)
    monkeypatch.chdir(tmp_path)
    web_dashboard.main(device="cpu")
    assert "warning" in empty.names()
    monkeypatch.setitem(sys.modules, "streamlit", None)  # not installed
    with pytest.raises(SystemExit, match="streamlit is not installed"):
        web_dashboard.main()
