"""The port's hybrid tokenization and hybrid dataset pipeline against the JAX
package's, then a hybrid-vocabulary model trained by both trainers.

- ``HybridTokenizer`` (74 tokens, the overlap refusal, minus-strand reverse
  complement, both decoders) and the k-mer tokenizer: equal outputs.
- ``extract_hybrid_flanked`` and ``tokenize_hybrid_flanked`` on GBFF files
  written inline (both strands, ``N`` in flanks): equal rows and ids; each
  split's ``.npz`` of ``build_hybrid_splits`` byte-equal.
- ``prepare_hybrid_datasets``: every artifact and ``pipeline_prepare.json``
  equal (the output roots aside), the skip, force and fingerprint rebuild
  rules, the itos rebuild, the pad-only gate, and both CLIs.
- The corrected-critic CLI: the same clusters, splits and manifest.
- On the hybrid splits (block 64, 1 layer, 2 heads, d16, float32, dropout
  0, termination loss on) both trainers run from one JAX init through
  ``transfer_from``: curves within ``CURVE_RTOL`` and logits within
  ``LOGIT_RTOL``. The packing separator id 3 is ``<UNK>`` in the hybrid
  vocabulary, so an ``N`` starts a segment inside a window in both. Both
  trainers give the termination loss the codon vocabulary's ``STOP_IDS``,
  which name other codons in the hybrid vocabulary (kept for parity).
"""

from __future__ import annotations

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from genomics_lm_tpu.data import hybrid_pipeline as jax_hp
from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.tokenizers import hybrid as jax_hybrid
from genomics_lm_tpu.tokenizers import kmer as jax_kmer
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_tpu.training import loop as jax_loop
from genomics_lm_torch.data import hybrid_pipeline as hp
from genomics_lm_torch.data.hybrid_tokenize import main as tokenize_cli
from genomics_lm_torch.data.pipeline_prepare_hybrid import main as prepare_cli
from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.masks import segment_ids_from_tokens
from genomics_lm_torch.protein.build_corrected_protein_critic_dataset import (
    main as critic_cli,
)
from genomics_lm_torch.tokenizers import codon, hybrid, kmer, kmer_tokenize
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training import loop
from genomics_lm_torch.utils.weights import params_from_jax
from tests.test_torch_genbank import gbff_text, genome_record, wait_for_jax_library

CURVE_RTOL = 1e-5
LOGIT_RTOL = 1e-4
BLOCK = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_gbffs(tmp_path, n_files=3, seed=2, n_cds=6):
    """One genome a file (``GCF_<n>_genomic.gbff``), genes on both strands,
    an ``N`` in two flanks and one overlapping CDS each."""
    rng = np.random.default_rng(seed)
    paths = []
    for g in range(n_files):
        seq, feats, _ = genome_record(rng, n_cds=n_cds, n_flank=2, overlaps=1)
        path = tmp_path / f"GCF_{g + 1:06d}.1_ASM{g}v1_genomic.gbff"
        path.write_text(gbff_text(f"HYB{g}", f"NZ_HYB{g:03d}.1", "Hybridus testus", seq, feats))
        paths.append(path)
    return paths


def test_tokenizers_equal_jax():
    tok, jtok = hybrid.HybridTokenizer(), jax_hybrid.HybridTokenizer()
    assert tok.vocab == jtok.vocab and tok.vocab_size == 74 and tok.stoi == jtok.stoi
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(0, 400))
        seq = "".join(rng.choice(list("ACGTNacgtRY"), n))
        cuts = sorted(rng.choice(max(n, 1), min(n, 6), replace=False).tolist()) if n else []
        intervals = [(a, b, str(rng.choice(["+", "-"]))) for a, b in zip(cuts[::2], cuts[1::2])]
        ids = tok.encode(seq, intervals)
        assert ids == jtok.encode(seq, intervals)
        assert tok.decode(ids) == jtok.decode(ids)
        assert tok.decode_genomic(ids, intervals) == jtok.decode_genomic(ids, intervals)
    assert tok.reverse_complement("ACGTNnacgtRY") == jtok.reverse_complement("ACGTNnacgtRY")
    for side in (tok, jtok):
        with pytest.raises(ValueError, match="Overlapping CDS"):
            side.encode("ACGT" * 10, [(0, 12, "+"), (9, 21, "-")])
    for k in (1, 2, 3):
        assert kmer.build_vocab(k) == jax_kmer.build_vocab(k)
        stoi = kmer.build_stoi(k)
        for seq in ("acgun", "ACGTTGCAN", " ttt \n", ""):
            assert kmer.to_ids(seq, k, stoi) == jax_kmer.to_ids(seq, k, stoi)
            for stride in (None, 1, 2):
                assert kmer_tokenize(seq, k, stride) == jax_kmer.kmer_tokenize(seq, k, stride)
    for bad in ((0, None), (3, 0)):
        for fn in (kmer_tokenize, jax_kmer.kmer_tokenize):
            with pytest.raises(ValueError):
                fn("ACGT", *bad)


def test_extraction_tokenization_and_splits_equal_jax(tmp_path):
    paths = write_gbffs(tmp_path)
    assert hp.genome_id_from_path(paths[0]) == jax_hp.genome_id_from_path(paths[0]) == "GCF_000001.1"
    for kw in ({}, {"min_len": 200, "upstream": 12, "downstream": 5}):
        rows = hp.extract_hybrid_flanked(paths, **kw)
        assert rows == jax_hp.extract_hybrid_flanked(paths, **kw)
    assert any("N" in r["sequence"] for r in rows)
    lines, genomes = hp.tokenize_hybrid_flanked(rows)
    assert (lines, genomes) == jax_hp.tokenize_hybrid_flanked(rows)
    for pack_mode in ("multi", "dynamic"):
        out = {}
        for side, lib in (("port", hp), ("jax", jax_hp)):
            d = tmp_path / f"{side}_{pack_mode}"
            out[side] = (lib.build_hybrid_splits(lines, genomes, d, block_size=BLOCK,
                                                 val_frac=0.25, test_frac=0.25,
                                                 pack_mode=pack_mode),
                         {p.name: p.read_bytes() for p in sorted(d.glob("*.npz"))})
        assert out["port"] == out["jax"]
        assert len(out["port"][1]) == 3
        for p in sorted((tmp_path / f"port_{pack_mode}").glob("*.npz")):
            assert hp.count_pad_only_windows(p) == jax_hp.count_pad_only_windows(p) == 0
    assert hp.count_pad_only_windows(tmp_path / "absent.npz") == -1


def prepared_tree(root) -> dict:
    """Every file under ``root`` by relative path; JSON with ``root`` masked."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            if p.suffix == ".json":
                data = data.replace(str(root).encode(), b"<root>")
            out[str(p.relative_to(root))] = data
    return out


def hybrid_cfg(paths, block=BLOCK):
    return {"data": {"block_size": block, "windows_per_seq": 1, "val_frac": 0.2,
                     "test_frac": 0.2},
            "datasets": [{"name": f"g{i}", "gbff": str(p), "min_len": 90}
                         for i, p in enumerate(paths)]}


def prepare_both(paths, tmp_path, run: str, **kw):
    results = {}
    for side, lib in (("port", hp), ("jax", jax_hp)):
        root = tmp_path / side
        results[side] = lib.prepare_hybrid_datasets(
            hybrid_cfg(paths), root / "runs" / run, run, out_root=root / "processed", **kw)
    return results


def test_prepare_hybrid_datasets_equals_jax(tmp_path):
    paths = write_gbffs(tmp_path)
    first = prepare_both(paths, tmp_path, "a")
    assert prepared_tree(tmp_path / "port") == prepared_tree(tmp_path / "jax")
    assert all(s["rebuilt"] for s in first["port"]["stages"])
    itos = (tmp_path / "port" / "processed" / "combined_hybrid" / "a" / "itos.txt")
    assert itos.read_text().splitlines() == hybrid.HybridTokenizer().vocab
    # reuse, force, a changed fingerprint, a stale itos: the same decisions
    for run, kw, rebuilt in (("b", {}, False), ("c", {"force": True}, True),
                             ("d", {"pack_mode": "binpack"}, True),
                             ("e", {"pack_mode": "binpack"}, False),
                             ("f", {"pack_mode": "binpack", "downstream": 20}, True)):
        res = prepare_both(paths, tmp_path, run, **kw)
        assert [s["rebuilt"] for s in res["port"]["stages"]] == [rebuilt] * len(paths), run
        assert prepared_tree(tmp_path / "port") == prepared_tree(tmp_path / "jax"), run
    for side in ("port", "jax"):
        (tmp_path / side / "processed" / "g1_hybrid" / "itos_hybrid.txt").write_text("<pad>\n")
    res = prepare_both(paths, tmp_path, "g", pack_mode="binpack", downstream=20)
    assert res["port"]["tokenization_state"]["bad_specials"]
    assert all(s["rebuilt"] for s in res["port"]["stages"])
    assert prepared_tree(tmp_path / "port") == prepared_tree(tmp_path / "jax")
    for side, lib in (("port", hp), ("jax", jax_hp)):
        for bad, match in (({"datasets": [{"name": "x"}]}, "missing keys"),
                           ({"datasets": [{"name": "x", "gbff": "/nope.gbff"}]}, "not found"),
                           ({"windows_per_seq": "lots", "datasets": [
                               {"name": "x", "gbff": str(paths[0])}]}, "windows_per_seq"),
                           ({}, "no datasets")):
            with pytest.raises(lib.HybridPipelineError, match=match):
                lib.prepare_hybrid_datasets(bad, tmp_path / side / "err", "x")


def test_the_pad_only_gate_fails_both_closed(tmp_path, monkeypatch):
    """A packer that leaves one pad-only window a split: both raise with the
    same counts and write the same ``integrity.json``; the CLI exits 3."""
    paths = write_gbffs(tmp_path, n_files=3)
    for lib in (hp, jax_hp):
        real = lib.packed_arrays

        def padded(windows, real=real, **kw):
            arrays = real(windows, **kw)
            arrays["Y"][0] = 0
            return arrays

        monkeypatch.setattr(lib, "packed_arrays", padded)
    errors = {}
    for side, lib in (("port", hp), ("jax", jax_hp)):
        root = tmp_path / side
        with pytest.raises(lib.HybridIntegrityError) as info:
            lib.prepare_hybrid_datasets(hybrid_cfg(paths), root / "run", "r",
                                        out_root=root / "processed")
        errors[side] = str(info.value).split(";")[0]
    assert errors["port"] == errors["jax"] == (
        "pad-only windows detected (would produce non-finite losses): "
        "{'train': 3, 'val': 3, 'test': 3}")
    assert prepared_tree(tmp_path / "port") == prepared_tree(tmp_path / "jax")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.dump(hybrid_cfg(paths)))
    assert prepare_cli(["--config", str(cfg_path), "--run-id", "cli", "--run-dir",
                        str(tmp_path / "cli"), "--out-root", str(tmp_path / "cli_out")]) == 3


def test_clis_equal_jax_s_scripts(tmp_path, capsys):
    from scripts.hybrid_tokenize import main as jax_tokenize_cli
    from scripts.pipeline_prepare_hybrid import main as jax_prepare_cli

    paths = write_gbffs(tmp_path)
    printed = {}
    for side, fn in (("port", tokenize_cli), ("jax", jax_tokenize_cli)):
        d = tmp_path / f"tok_{side}"
        assert fn(["--gbff", *map(str, paths), "--out_ids", str(d / "ids.txt"),
                   "--max_len", "300"]) == 0
        printed[side] = (capsys.readouterr().out.replace(str(d), "<d>"),
                         (d / "ids.txt").read_bytes(), (d / "itos_hybrid.txt").read_bytes())
    assert printed["port"] == printed["jax"]
    assert json.loads(printed["port"][0])["dropped_overlapping_cds"] == len(paths)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.dump(hybrid_cfg(paths[:2])))
    for side, fn in (("port", prepare_cli), ("jax", jax_prepare_cli)):
        root = tmp_path / f"cli_{side}"
        assert fn(["--config", str(cfg_path), "--run-id", "cli", "--run-dir", str(root / "run"),
                   "--out-root", str(root / "processed"), "--pack_mode", "binpack",
                   "--extra-dataset", f"extra,{paths[2]},120"]) == 0
        printed[side] = capsys.readouterr().out.replace(str(root), "<root>")
    assert printed["port"] == printed["jax"]
    assert prepared_tree(tmp_path / "cli_port") == prepared_tree(tmp_path / "cli_jax")


def test_corrected_critic_cli_equals_jax_s(tmp_path, capsys):
    from scripts.build_corrected_protein_critic_dataset import main as jax_critic_cli

    wait_for_jax_library()
    rng = np.random.default_rng(8)
    amino = list("ACDEFGHIKLMNPQRSTVWY")
    ann, stab = tmp_path / "ann.tsv", tmp_path / "stab.csv"
    with ann.open("w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["ncbi_id", "sequence", "pfam", "ec"])
        for i in range(40):
            base = "".join(rng.choice(amino, int(rng.integers(40, 90))))
            w.writerow([f"WP_{i}", base, f"PF{i % 5:05d};PF9", f"{1 + i % 7}.1.1.1"])
            if i % 4 == 0:  # a near-duplicate: clusters with it
                mut = list(base)
                mut[3] = "W"
                w.writerow([f"WP_{i}b", "".join(mut) + "*", "", f"{1 + i % 7}.2"])
        w.writerow(["WP_bad", "MKXZ", "PF1", "1"])
    with stab.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "aa_seq", "deltaG"])
        for i in range(12):
            w.writerow([f"d{i}", "".join(rng.choice(amino, 50)), f"{rng.normal():.3f}"])
    outs = {}
    for side, fn in (("port", critic_cli), ("jax", jax_critic_cli)):
        d = tmp_path / side
        assert fn(["--annotations", str(ann), "--stability_csv", str(stab), "--out_dir", str(d),
                   "--min_jaccard", "0.4", "--seed", "3"]) == 0
        outs[side] = (capsys.readouterr().out.replace(str(d), "<d>"),
                      prepared_tree(d))
    assert outs["port"] == outs["jax"]
    summary = json.loads(outs["port"][0])
    assert summary["clusters"] < summary["records"] and min(summary["split_counts"].values()) > 0


def assert_rel(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-12)
    assert err <= rtol, f"{what}: {err} > {rtol}"


def test_hybrid_trainer_tracks_the_jax_trainer(tmp_path):
    paths = write_gbffs(tmp_path, n_files=4, n_cds=8)
    result = hp.prepare_hybrid_datasets(hybrid_cfg(paths), tmp_path / "prep", "hyb",
                                        out_root=tmp_path / "processed")
    with np.load(result["train_npz"]) as z:
        X = z["X"]
    # an N inside a window: <UNK> (the packing separator's id) starts a segment there
    unk = hybrid.HybridTokenizer().stoi["<UNK>"]
    assert unk == hp.HYBRID_PACK_SEP_ID == 3
    rows_with_n = [i for i in range(len(X)) if any(
        X[i, t] == unk and X[i, t - 1] not in (0, hybrid.HybridTokenizer().stoi["<EOS_CDS>"],
                                               hybrid.HybridTokenizer().stoi["<UTR_END>"])
        for t in range(1, X.shape[1]))]
    assert rows_with_n
    segs = segment_ids_from_tokens(torch.from_numpy(X[rows_with_n[:1]]).long(), sep_id=3)
    assert int(segs.max()) >= 1

    jcfg = JaxConfig(vocab_size=74, block_size=BLOCK, n_layer=1, n_head=2, n_embd=16,
                     dropout=0.0, termination_aux=True)
    init = tmp_path / "init" / "checkpoints" / "init.npz"
    init.parent.mkdir(parents=True)
    jckpt.save_checkpoint({"model": jax_gpt.init(jax.random.PRNGKey(3), jcfg)}, init)
    (tmp_path / "init" / "itos.txt").write_text(
        "\n".join(hybrid.HybridTokenizer().vocab) + "\n")
    cfg = dict(train_npz=result["train_npz"], val_npz=result["val_npz"], block_size=BLOCK,
               n_layer=1, n_head=2, n_embd=16, dropout=0.0, batch_size=4, grad_accum_steps=2,
               lr=1e-3, min_lr=1e-4, warmup_steps=2, epochs=1, seed=0, early_stop_patience=0,
               termination_aux=True, termination_loss_enabled=True)
    runs = str(tmp_path / "runs")
    jmeta = jax_loop.run_training(dict(cfg, run_id="jax"), transfer_from=str(init),
                                  run_root=runs)
    tmeta = loop.run_training(dict(cfg, run_id="port"), transfer_from=str(init),
                              run_root=runs, device="cpu")
    assert jmeta["status"] == tmeta["status"] == "completed"
    assert tmeta["model_spec"]["vocab_size"] == jmeta["model_spec"]["vocab_size"] == 74
    jp = jckpt.load_checkpoint(tmp_path / "runs" / "jax" / "checkpoints" / "last.npz")
    tp = tckpt.load_checkpoint(tmp_path / "runs" / "port" / "checkpoints" / "last.npz")
    assert tp["step"] == jp["step"] > 0
    for key in ("train_loss", "val_loss", "val_next_loss", "train_next_loss"):
        assert_rel(tp[key], jp[key], CURVE_RTOL, key)
    itos = (tmp_path / "runs" / "port" / "itos.txt").read_text().splitlines()
    assert itos == hybrid.HybridTokenizer().vocab

    x = np.load(result["val_npz"])["X"][:4]
    want, _ = jax_gpt.forward(jax.tree.map(jnp.asarray, jp["model"]), jcfg, jnp.asarray(x))
    tcfg = CodonGPTConfig.from_run_config(tp["cfg"])
    with torch.no_grad():
        got, _ = codon_gpt.forward(params_from_jax(tp["model"], tcfg, "cpu"), tcfg,
                                   torch.from_numpy(x).long())
    assert_rel(got.numpy(), want, LOGIT_RTOL, "last.npz logits")

    # both trainers hand the termination loss the codon vocabulary's stop ids,
    # which are other codons in the hybrid vocabulary
    assert loop.STOP_IDS == jax_loop.STOP_IDS == codon.STOP_IDS
    assert [itos[i] for i in codon.STOP_IDS] != ["TAA", "TAG", "TGA"]
    hybrid_stops = [itos.index(c) for c in ("TAA", "TAG", "TGA")]
    other = loop.run_training(dict(cfg, run_id="port-stops", termination_stop_ids=hybrid_stops),
                              transfer_from=str(init), run_root=runs, device="cpu")
    op = tckpt.load_checkpoint(tmp_path / "runs" / "port-stops" / "checkpoints" / "last.npz")
    assert other["status"] == "completed"
    assert abs(op["train_loss"] - tp["train_loss"]) > 1e-3 * abs(tp["train_loss"])
