"""PyTorch port of the model's extraction forwards, embedding extraction
and the analysis reports, against the JAX package on the CPU.

The same numpy weights and token rows go through
``genomics_lm_tpu.models.codon_gpt.hidden_states`` / ``forward_hidden`` /
``attention_maps``, ``evals/embeddings.py::extract_embeddings`` and the
four reports of ``evals/analysis.py`` and through the port's (2 layers,
d 32–48, float32; dense with learned positions, RoPE with GQA, and MoE),
with windows and ``<SEP>`` segments. States, maps, embeddings and the
embedding-table PCA agree within 1e-5 (float32 sums in different orders);
the reports' JSON is equal. The CLIs run on a trained run.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from genomics_lm_tpu.data.datasets import PackedDataset as JaxPackedDataset
from genomics_lm_tpu.evals import analysis as jax_analysis
from genomics_lm_tpu.evals import embeddings as jax_emb
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_torch.data.datasets import PackedDataset
from genomics_lm_torch.evals import analysis, embeddings
from genomics_lm_torch.evals.analyze_attention import main as attention_cli
from genomics_lm_torch.evals.extract_embeddings import main as extract_cli
from genomics_lm_torch.evals.visualizer import pca_2d
from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.tokenizers.codon import VOCAB, write_itos
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax

ATOL = 1e-5

VARIANTS = {
    "dense": {},
    "rope_gqa_swiglu": {"use_rope": True, "n_kv_head": 2, "use_swiglu": True},
    "moe_top2": {"moe_experts": 4, "moe_top_k": 2, "fused_qkv": True},
}


def make_pair(seed=0, **over):
    kw = dict(vocab_size=68, block_size=48, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
              sep_id=3)
    kw.update(over)
    jcfg, tcfg = JaxConfig(**kw), CodonGPTConfig(**kw)
    params = jax_gpt.init(jax.random.PRNGKey(seed), jcfg)
    return params, jcfg, params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu"), tcfg


def rows(seed, B=5, T=40, pad=True):
    x = np.random.default_rng(seed).integers(4, 68, (B, T)).astype(np.int32)
    x[:, 0] = 1
    x[0, 13] = x[1, 7] = 3  # <SEP> segments
    if pad:
        x[2, 25:] = 0
        x[3, 31:] = 0
        x[3, 30] = 2
    return x


@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hidden_states_and_maps_match_jax(variant, window):
    params, jcfg, model, tcfg = make_pair(**VARIANTS[variant])
    idx = rows(1, pad=False)
    want = jax_gpt.hidden_states(params, jcfg, idx, attention_window=window)
    want_maps = jax_gpt.attention_maps(params, jcfg, idx, attention_window=window)
    x = torch.from_numpy(idx).long()
    with torch.no_grad():
        got = codon_gpt.hidden_states(model, tcfg, x, attention_window=window)
        final = codon_gpt.forward_hidden(model, tcfg, x, attention_window=window)
        maps = codon_gpt.attention_maps(model, tcfg, x, attention_window=window)
    assert [tag for tag, _ in got] == [tag for tag, _ in want] == [0, 1, 2, "final"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert torch.equal(final, got[-1][1])
    assert len(maps) == len(want_maps) == 2
    for g, w in zip(maps, want_maps):
        assert g.shape == (5, 4, 40, 40)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, atol=1e-6)
    # masked entries are exactly 0: the future, outside the window, other segments
    mask = torch.ones(40, 40, dtype=torch.bool).tril()
    if window is not None:
        mask &= ~torch.ones(40, 40, dtype=torch.bool).tril(-window)
    assert (maps[0][:, :, ~mask] == 0).all()
    assert (maps[1][0, :, 13:, :13] == 0).all()


def test_flash_hidden_states_match_the_einsum_path():
    """Under ``attention_impl="flash"`` the states come from the flash
    forward (its plain version on the CPU), equal to the einsum path's."""
    _, _, model, tcfg = make_pair(moe_experts=4, fused_qkv=True)
    x = torch.from_numpy(rows(2, pad=False)).long()
    with torch.no_grad():
        want = codon_gpt.hidden_states(model, tcfg, x, attention_window=4)
        got = codon_gpt.hidden_states(model, tcfg.replace(attention_impl="flash"), x,
                                      attention_window=4)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


@pytest.mark.parametrize("mode", embeddings.POOLING_MODES)
@pytest.mark.parametrize("variant", ["dense", "moe_top2"])
def test_extract_embeddings_match_jax(variant, mode):
    params, jcfg, model, tcfg = make_pair(**VARIANTS[variant])
    x = rows(3)
    want = jax_emb.extract_embeddings(params, jcfg, x, mode=mode, batch_size=2)
    got = embeddings.extract_embeddings(model, tcfg, x, mode=mode, batch_size=2)
    assert got.dtype == np.float32 and got.shape == (5, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError, match="pooling"):
        embeddings.extract_embeddings(model, tcfg, x, mode="max")


def test_ids_and_provenance_match_jax(tmp_path):
    dna = "ATGAAACCCGGGTTTTAA"
    np.testing.assert_array_equal(embeddings.ids_from_dna(dna, 12), jax_emb.ids_from_dna(dna, 12))
    np.testing.assert_array_equal(embeddings.ids_from_dna(dna * 9, 12),
                                  jax_emb.ids_from_dna(dna * 9, 12))
    path = tmp_path / "itos.txt"
    write_itos(path)
    kw = dict(checkpoint_path=path, itos_path=path, dataset_manifest_id="ds", pooling="eos",
              n_sequences=3)
    assert embeddings.extraction_provenance(**kw) == jax_emb.extraction_provenance(**kw)


def write_split(tmp_path, name="val", n=40, T=48):
    x = rows(4, B=n, T=T)
    y = np.roll(x, -1, axis=1)
    y[:, -1] = 0
    np.savez(tmp_path / f"{name}.npz", X=x, Y=y)
    return tmp_path / f"{name}.npz"


def test_analysis_reports_match_jax(tmp_path):
    params, jcfg, model, tcfg = make_pair(**VARIANTS["moe_top2"])
    split = write_split(tmp_path)
    itos = list(VOCAB)
    stoi = {t: i for i, t in enumerate(itos)}
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    reports = {}
    for side, out in (("jax", jdir), ("port", tdir)):
        if side == "jax":
            reports[side] = [
                jax_analysis.analyze_frequencies(JaxPackedDataset(str(split)), itos, out),
                jax_analysis.analyze_embeddings(params, out, itos),
                jax_analysis.analyze_attention(params, jcfg, "ATGAAACCCGGGTTTTAA", out, itos,
                                               stoi),
                jax_analysis.probe_next_token(params, jcfg, JaxPackedDataset(str(split)), out,
                                              n_batches=3, batch_size=8),
            ]
        else:
            reports[side] = [
                analysis.analyze_frequencies(PackedDataset(str(split)), itos, out),
                analysis.analyze_embeddings(model, out, itos),
                analysis.analyze_attention(model, tcfg, "ATGAAACCCGGGTTTTAA", out, itos, stoi),
                analysis.probe_next_token(model, tcfg, PackedDataset(str(split)), out,
                                          n_batches=3, batch_size=8),
            ]
    assert reports["port"][:3] == reports["jax"][:3]
    for key, value in reports["jax"][3].items():
        assert reports["port"][3][key] == pytest.approx(value, abs=ATOL)
    for name in ("frequencies.json", "next_token_probe.json"):
        got, want = (json.loads((d / name).read_text()) for d in (tdir, jdir))
        assert got.keys() == want.keys()
    for name in ["embedding_pca.png"] + [f"attention_layer{i}.png" for i in range(2)]:
        assert (tdir / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # the PCA equals sklearn's up to each axis's sign
    from sklearn.decomposition import PCA

    emb = np.asarray(params["tok_emb"], np.float64)
    want = PCA(n_components=2).fit_transform(emb)
    got = pca_2d(emb)
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=ATOL)


def test_cli_extracts_and_maps_a_trained_run(tmp_path, capsys):
    _, _, model, tcfg = make_pair(**VARIANTS["moe_top2"])
    run = tmp_path / "runs" / "r"
    (run / "checkpoints").mkdir(parents=True)
    cfg = dict(vocab_size=68, block_size=48, n_layer=2, n_head=4, n_embd=32, dropout=0.0,
               moe_experts=4, moe_top_k=2, fused_qkv=True)
    tckpt.save_checkpoint({"model": params_to_jax(model, tcfg), "cfg": cfg},
                          run / "checkpoints" / "best.npz")
    write_itos(run / "itos.txt")
    fasta = tmp_path / "cds.fasta"
    fasta.write_text(">a first\nATGAAACCC\nGGGTAA\n>b\nATGTTTTTTTGA\n")
    out = tmp_path / "emb.npz"
    argv = ["r", "--run_root", str(tmp_path / "runs"), "--input", str(fasta), "--out", str(out),
            "--pooling", "eos", "--device", "cpu"]
    assert extract_cli(argv) == 0
    data = np.load(out)
    assert data["X"].shape == (2, 32) and list(data["ids"]) == ["a", "b"]
    rows_ = np.stack([embeddings.ids_from_dna(s, 48) for s in ("ATGAAACCCGGGTAA", "ATGTTTTTTTGA")])
    np.testing.assert_array_equal(
        data["X"], embeddings.extract_embeddings(model, tcfg, rows_, mode="eos"))
    prov = json.loads(out.with_suffix(".provenance.json").read_text())
    assert prov["validation_status"] == "causal_verified" and prov["pooling"] == "eos"
    assert prov["checkpoint"]["sha256"] == embeddings.file_sha256(run / "checkpoints" / "best.npz")
    from genomics_lm_torch.evals.provenance import EvaluationProvenanceError

    with pytest.raises(EvaluationProvenanceError, match="dataset_manifest"):
        extract_cli(argv + ["--require_scientific_valid"])
    assert attention_cli(["r", "--run_root", str(tmp_path / "runs"), "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert report["n_layers"] == 2 and report["tokens"][0] == "<BOS_CDS>"
    assert (run / "charts" / "attention_layer1.png").exists()
