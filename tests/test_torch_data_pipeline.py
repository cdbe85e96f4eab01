"""PyTorch port of dataset preparation against the JAX package.

From the same records both packages must write the same dataset: the
ambiguity-aware fragments and their counters, the demo corpus TSV, every
``.npz`` array, ``.npy`` sidecar, TSV, ``leakage_audit.json`` and the
manifest byte for byte, so that the manifest's content-addressed
``dataset.id`` is JAX's. The exact-duplicate quarantine, the fail-closed
group split and the CLIs are held the same way. Everything here is numpy
on the host: exact equality, no tolerance.
"""

from __future__ import annotations

import csv
import dataclasses
import json

import numpy as np
import pytest

from genomics_lm_tpu.data import leakage as jax_leakage
from genomics_lm_tpu.data import pipeline as jax_pipeline
from genomics_lm_tpu.tokenizers import codon as jax_codon
from genomics_lm_torch.data import leakage, pipeline
from genomics_lm_torch.data.demo_corpus import main as demo_corpus
from genomics_lm_torch.data.manifest import validate_dataset_manifest
from genomics_lm_torch.data.pipeline_prepare import main as prepare_cli
from genomics_lm_torch.tokenizers import codon

IUPAC = "ACGT" * 6 + "RYSWKMBDHVN" + "acgtu"


def random_cds(rng, n_bases: int, ambiguity: float) -> str:
    bases = rng.choice(list("ACGT"), n_bases)
    hit = rng.random(n_bases) < ambiguity
    bases[hit] = rng.choice(list(IUPAC), int(hit.sum()))
    pad = " \n" if rng.random() < 0.3 else ""
    return pad + "".join(bases) + pad


def as_dicts(result):
    return ([dataclasses.asdict(f) for f in result.fragments],
            (result.ambiguous_codons, result.discarded_fragments,
             result.partial_trailing_bases, result.source_had_ambiguity))


@pytest.mark.parametrize("termination", ["eos", "sep", "none"])
def test_fragments_match_jax(termination):
    rng = np.random.default_rng(11)
    for i in range(200):
        dna = random_cds(rng, int(rng.integers(0, 200)), float(rng.choice([0.0, 0.01, 0.1])))
        for min_codons in (1, 3, 10):
            got = codon.tokenize_cds_fragments(dna, source_id=f"s{i}",
                                               min_fragment_codons=min_codons,
                                               termination=termination)
            want = jax_codon.tokenize_cds_fragments(dna, source_id=f"s{i}",
                                                    min_fragment_codons=min_codons,
                                                    termination=termination)
            assert as_dicts(got) == as_dicts(want)
    with pytest.raises(ValueError, match="at least 1"):
        codon.tokenize_cds_fragments("ATG", min_fragment_codons=0)


def test_tokenize_file_matches_jax(tmp_path):
    rng = np.random.default_rng(12)
    src = tmp_path / "cds.txt"
    src.write_text("\n".join(random_cds(rng, int(rng.integers(20, 300)), 0.02)
                             for _ in range(40)) + "\n")
    outs = {}
    for side, fn in (("port", codon.tokenize_file), ("jax", jax_codon.tokenize_file)):
        d = tmp_path / side
        stats = fn(src, d / "ids.txt", d / "vocab.tsv", d / "itos.txt", min_fragment_codons=5)
        outs[side] = (stats, *((d / n).read_bytes() for n in
                               ("ids.txt", "vocab.tsv", "itos.txt", "ids.txt.fragments.tsv")))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]["ambiguous_codons"] > 0


def test_demo_corpus_is_byte_equal_to_the_script(tmp_path, capsys):
    from scripts.make_demo_corpus import main as jax_demo

    args = ["--genes", "60", "--genera", "3", "--genomes_per_genus", "2", "--seed", "5",
            "--coupling", "0.4"]
    assert demo_corpus(["--out", str(tmp_path / "port.tsv"), *args]) == 0
    assert jax_demo(["--out", str(tmp_path / "jax.tsv"), *args]) == 0
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    assert capsys.readouterr().out.count("wrote 60 genes") == 2


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "records.tsv"
    demo_corpus(["--out", str(path), "--genes", "60", "--seed", "3", "--min_codons", "20",
                 "--max_codons", "90"])
    with path.open() as f:
        return [dict(r) for r in csv.DictReader(f, delimiter="\t")]


def prepare_both(records, tmp_path, **kwargs) -> dict:
    """Run both packages' ``prepare_dataset``; return each manifest and dir."""
    out = {}
    for side, fn in (("port", pipeline.prepare_dataset), ("jax", jax_pipeline.prepare_dataset)):
        out[side] = (fn([dict(r) for r in records], tmp_path / side, **kwargs), tmp_path / side)
    return out


def assert_same_dataset(out) -> None:
    (port_manifest, port_dir), (jax_manifest, jax_dir) = out["port"], out["jax"]
    assert port_manifest["dataset"]["id"] == jax_manifest["dataset"]["id"]
    assert port_manifest == jax_manifest
    names = sorted(p.name for p in jax_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == names
    for name in names:
        if name.endswith(".npz"):
            with np.load(port_dir / name) as got, np.load(jax_dir / name) as want:
                assert sorted(got.files) == sorted(want.files)
                for key in want.files:
                    assert got[key].dtype == want[key].dtype
                    np.testing.assert_array_equal(got[key], want[key])
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


@pytest.mark.parametrize("pack_mode", ["multi", "binpack"])
def test_prepare_dataset_matches_jax(records, tmp_path, pack_mode):
    out = prepare_both(records, tmp_path, block_size=64, pack_mode=pack_mode,
                       group_by="genome", split_seed=7, skip_homology=True)
    assert_same_dataset(out)
    manifest, d = out["port"]
    validate_dataset_manifest(manifest, d / "manifest.json", verify_artifacts=True)
    counts = manifest["split_policy"]["record_counts"]
    assert min(counts.values()) > 0 and sum(counts.values()) == len(records)
    assert manifest["dataset"]["scientific_valid"] is False  # homology skipped
    for split in ("train", "val", "test"):
        with np.load(d / f"{split}_bs64.npz") as z:
            assert z["X"].shape[1] == 64 and len(z["X"]) > 0
    audit = json.loads((d / "leakage_audit.json").read_text())
    assert audit["status"] == "passed" and audit["protein_homology"] is None


def test_quarantine_of_exact_duplicates_matches_jax(records, tmp_path):
    """A few sequences copied into other genomes' records: the split that
    ranks first keeps each family, the others drop it, in both packages."""
    dup = [dict(r) for r in records]
    for i, j in ((0, 7), (1, 26), (2, 33), (5, 40), (9, 51)):
        dup.append(dict(records[i], source_id=f"copy{i}_{j}", genome=records[j]["genome"],
                        genus=records[j]["genus"]))
    splits, _ = pipeline.assign_group_splits(dup, group_by="genome", seed=7)
    kept, report = leakage.quarantine_cross_split_exact_duplicates(splits)
    jsplits, _ = jax_pipeline.assign_group_splits(dup, group_by="genome", seed=7)
    jkept, jreport = jax_leakage.quarantine_cross_split_exact_duplicates(jsplits)
    assert report == jreport and kept == jkept and splits == jsplits
    assert report["removed_record_count"] > 0
    out = prepare_both(dup, tmp_path, block_size=64, group_by="genome", split_seed=7,
                       skip_homology=True)
    assert_same_dataset(out)
    assert out["port"][0]["quarantine"]["removed_record_count"] == report["removed_record_count"]


def test_exact_duplicates_fail_the_audit_like_jax(tmp_path):
    rows = [{"sequence": "ATGAAACCCGGGTTTTAA", "source_id": "a", "split": "train"},
            {"sequence": "atgaaacccgggttttaa", "source_id": "b", "split": "test"},
            {"sequence": "ATGCCCTAA", "source_id": "c", "split": "val"}]
    errors = {}
    for side, lib in (("port", leakage), ("jax", jax_leakage)):
        with pytest.raises(RuntimeError) as info:
            lib.audit_source_records(rows, tmp_path / side / "audit.json", skip_homology=True)
        errors[side] = (type(info.value).__name__, str(info.value),
                        (tmp_path / side / "audit.json").read_bytes())
    assert errors["port"] == errors["jax"]
    assert b'"status": "failed"' in errors["port"][2]
    report = leakage.audit_source_records(rows, tmp_path / "ok.json", skip_homology=True,
                                          allow_exact_duplicates=True)
    assert report == jax_leakage.audit_source_records(
        rows, tmp_path / "ok_jax.json", skip_homology=True, allow_exact_duplicates=True)


def test_too_few_groups_fail_closed_in_both(records, tmp_path):
    two = [dict(r, genome=f"g{i % 2}") for i, r in enumerate(records)]
    for fn, err in ((pipeline.prepare_dataset, leakage.LeakageAuditError),
                    (jax_pipeline.prepare_dataset, jax_leakage.LeakageAuditError)):
        with pytest.raises(err, match="fewer than 3 genome groups"):
            fn(two, tmp_path / "refused", block_size=64, skip_homology=True)
    out = prepare_both(two, tmp_path, block_size=64, skip_homology=True,
                       allow_sequence_split=True)
    assert_same_dataset(out)
    assert out["port"][0]["split_policy"]["effective_group_by"] == "sequence"


def test_unported_engines_raise(records, tmp_path, capsys):
    """The two engines the port once refused now run and equal JAX (the
    name is kept from then): the native homology audit (JAX's library loaded,
    not its fallback) and ``--gbff``. The external tools absent, both
    packages still fail closed with the report written."""
    from genomics_lm_tpu import native as jax_native
    from tests.test_torch_genbank import wait_for_jax_library, write_genomes

    wait_for_jax_library()
    assert jax_native.available()
    kw = dict(block_size=64, skip_homology=False, audit_engine="native")
    got = pipeline.prepare_dataset(records, tmp_path / "native", **kw)
    want = jax_pipeline.prepare_dataset(records, tmp_path / "native_jax", **kw)
    assert got["dataset"]["id"] == want["dataset"]["id"]
    assert ((tmp_path / "native" / "leakage_audit.json").read_bytes()
            == (tmp_path / "native_jax" / "leakage_audit.json").read_bytes())
    audit = json.loads((tmp_path / "native" / "leakage_audit.json").read_text())
    assert audit["protein_homology"]["tool"]["name"] == "genomics_native_minhash"
    gbff = write_genomes(tmp_path)
    assert prepare_cli(["--gbff", *map(str, gbff), "--block_size", "64", "--skip_homology",
                        "--out_dir", str(tmp_path / "g")]) == 0
    want = jax_pipeline.prepare_from_genbank(gbff, tmp_path / "g_jax", block_size=64,
                                             skip_homology=True)
    assert f"[prepare] dataset_id={want['dataset']['id']}" in capsys.readouterr().out
    # the external tools are absent: both packages fail closed, with the report written
    for side, lib in (("port", leakage), ("jax", jax_leakage)):
        rows = [dict(r, split=s) for r, s in zip(records[:3], ("train", "val", "test"))]
        with pytest.raises(RuntimeError, match="not found"):
            lib.audit_source_records(rows, tmp_path / side / "audit.json",
                                     executable="mmseqs-absent")
        assert json.loads((tmp_path / side / "audit.json").read_text())["status"] == "error"


def test_prepare_cli_matches_jax(records, tmp_path, capsys):
    tsv = tmp_path / "records.tsv"
    with tsv.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(records[0]), delimiter="\t")
        writer.writeheader()
        writer.writerows(records)
    args = ["--records_tsv", str(tsv), "--block_size", "64", "--skip_homology",
            "--audit_engine", "native"]
    assert prepare_cli(args + ["--out_dir", str(tmp_path / "port")]) == 0
    printed = capsys.readouterr().out
    want = jax_pipeline.prepare_dataset(records, tmp_path / "jax", block_size=64,
                                        skip_homology=True, audit_engine="native")
    assert f"[prepare] dataset_id={want['dataset']['id']}" in printed
    assert ((tmp_path / "port" / "manifest.json").read_bytes()
            == (tmp_path / "jax" / "manifest.json").read_bytes())
