"""The port's GenBank parser, extractors and ``prepare_from_genbank`` against
the JAX package's.

The same GBFF text, written inline, goes to both packages: every field of
every record and feature, and every row of the four extractors, must be
equal, on the edge cases of the format (``join``/``order``/
``complement(join(...))`` locations, single bases, ``<``/``>`` partial
marks, qualifiers wrapped over lines with ``/translation`` joined without
spaces, a location continued on the next line, a record without
``ACCESSION``, several records in a file, lower-case ``ORIGIN`` and ``N``
bases). ``prepare_from_genbank`` must give JAX's ``dataset.id`` and
byte-equal split ``.npz`` files, with the homology audit skipped and with
the native minhash engine on (JAX's library loaded, not its fallback), and
keep JAX's precedence of the genus expression. Host code: exact equality.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

from genomics_lm_tpu import native as jax_native
from genomics_lm_tpu.data import genbank as jax_genbank
from genomics_lm_tpu.data import leakage as jax_leakage
from genomics_lm_tpu.data import pipeline as jax_pipeline
from genomics_lm_torch.data import genbank, leakage, pipeline
from genomics_lm_torch.data.pipeline_prepare import main as prepare_cli

SENSE = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
         if a + b + c not in ("TAA", "TAG", "TGA")]

EDGE_GBFF = """LOCUS       EDGE1                  150 bp    DNA     linear   BCT 01-JAN-2020
DEFINITION  Edge case chromosome one,
            with a wrapped definition.
ACCESSION   EDGE001 EDGE001B
VERSION     EDGE001.1
SOURCE      Edgeus casei
  ORGANISM  Edgeus casei
            Bacteria; Pseudomonadota.
FEATURES             Location/Qualifiers
     source          1..150
                     /organism="Edgeus casei"
     gene            4..12
                     /gene="abcA"
     CDS             join(4..12,20..31)
                     /locus_tag="E_0001"
                     /product="a product that wraps over
                     two lines of text"
                     /translation="MKVLAAGMKV
                     LAAGWW"
                     /pseudo
     CDS             complement(join(40..48,
                     52..63))
                     /locus_tag="E_0002"
                     /note="one line"
     CDS             order(70..72,80..85)
                     /gene="ordB"
     CDS             <90..>101
                     /locus_tag="E_0004"
     CDS             complement(<103..>114)
     CDS             complement(118)
     CDS             121
     CDS             25..45
                     /note="overlaps the first and second CDS"
     misc_feature    complement(130..140)
                     /note="not a CDS"
ORIGIN
        1 aaaatgaaat aacccccttt acatcccccc gggggtttta aaccggttaa ccggttaacc
       61 atgnnnacgt tttaaacccg ggatgcatgc tagctagcta gctgatcgat cgatcgnnna
      121 cgtacgtacg tacgtacgta cgtacgtacg
//
LOCUS       EDGE2                   60 bp    DNA     circular BCT 01-JAN-2020
DEFINITION  A record without an accession.
SOURCE      Edgeus other
FEATURES             Location/Qualifiers
     CDS             1..9
                     /locus_tag="F_0001"
     CDS             complement(20..40)
                     /product="second"
ORIGIN
        1 atgaaataag ggtttcccat tacgcgcgta acgtttgcat ggatcctaag cttnnnatga
//
"""


def records_as_dicts(module, path):
    return [dataclasses.asdict(r) for r in module.parse_genbank(path)]


def test_parser_and_extractors_equal_jax_on_the_edge_cases(tmp_path):
    path = tmp_path / "edge.gbff"
    path.write_text(EDGE_GBFF)
    got, want = records_as_dicts(genbank, path), records_as_dicts(jax_genbank, path)
    assert got == want
    # the edge cases the file holds, as JAX parses them
    first, second = want
    assert (first["accession"], second["accession"], second["name"]) == ("EDGE001", "", "EDGE2")
    cds = [f for f in first["features"] if f["type"] == "CDS"]
    assert cds[0]["intervals"] == [(3, 12), (19, 31)]
    assert cds[0]["qualifiers"]["translation"] == "MKVLAAGMKVLAAGWW"
    assert cds[0]["qualifiers"]["product"] == "a product that wraps over two lines of text"
    assert cds[0]["qualifiers"]["pseudo"] == "true"
    assert (cds[1]["strand"], cds[1]["intervals"]) == ("-", [(39, 48), (51, 63)])
    assert cds[2]["intervals"] == [(69, 72), (79, 85)]
    assert cds[3]["partial"] and cds[4]["partial"] and cds[4]["strand"] == "-"
    assert cds[5]["intervals"] == [(117, 118)] and cds[6]["intervals"] == [(120, 121)]
    assert "N" in first["sequence"] and first["sequence"].isupper()
    for name, kw in (("extract_cds_records", {}),
                     ("extract_genomic_tape", {"window": 40, "stride": 25}),
                     ("extract_anchored_operons", {"upstream": 7, "downstream": 11}),
                     ("extract_hybrid_records", {})):
        rows = getattr(genbank, name)(path, **kw)
        assert rows == getattr(jax_genbank, name)(path, **kw), name
        assert rows
    hybrid = genbank.extract_hybrid_records(path)
    assert hybrid[0]["dropped_overlapping"] > 0
    for seq in ("ACGTRYKMSWBDHVN", "acgtrykmswbdhvn", ""):
        assert genbank.reverse_complement(seq) == jax_genbank.reverse_complement(seq)
    for loc in ("join(1..5,8..10)", "complement(join(1..5,8..10))", "<1..>99", "7",
                "complement(complement(3..9))", "order(1..2, 5..6)", "bogus"):
        assert genbank._parse_location(loc) == jax_genbank._parse_location(loc)


def random_cds(rng, n_codons: int) -> str:
    return "ATG" + "".join(rng.choice(SENSE, n_codons)) + str(rng.choice(["TAA", "TAG", "TGA"]))


def genome_record(rng, *, n_cds: int, paralog_every: int = 0, n_flank: int = 0,
                  overlaps: int = 0):
    """(sequence, CDS features): genes on both strands between 60–200 nt
    spacers; ``paralog_every`` repeats a gene with a few codons changed, and
    ``n_flank`` puts an ``N`` into that many spacers."""
    seq, features, genes = [], [], []
    pos = 0
    for i in range(n_cds):
        spacer = list(rng.choice(list("ACGT"), int(rng.integers(60, 201))))
        if i < n_flank:
            spacer[-5] = "N"
        seq.append("".join(spacer))
        pos += len(spacer)
        if paralog_every and genes and i % paralog_every == 0:
            codons = [genes[-1][j:j + 3] for j in range(0, len(genes[-1]), 3)]
            for j in rng.choice(np.arange(1, len(codons) - 1), 3, replace=False):
                codons[j] = str(rng.choice(SENSE))
            gene = "".join(codons)
        else:
            gene = random_cds(rng, int(rng.integers(40, 120)))
        genes.append(gene)
        minus = bool(i % 2)
        seq.append(genbank.reverse_complement(gene) if minus else gene)
        loc = f"{pos + 1}..{pos + len(gene)}"
        features.append((f"complement({loc})" if minus else loc, i))
        pos += len(gene)
    for k in range(overlaps):  # a CDS reaching into the next gene
        loc, i = features[2 * k]
        start, end = (int(x) for x in loc.strip("complement()").split(".."))
        features.append((f"{start + 30}..{end + 90}", len(features)))
    seq.append("".join(rng.choice(list("ACGT"), 80)))
    return "".join(seq), features, genes


def gbff_text(locus: str, accession: str | None, organism: str | None, seq: str,
              features) -> str:
    lines = [f"LOCUS       {locus}  {len(seq)} bp    DNA     linear   BCT 01-JAN-2020",
             f"DEFINITION  {locus} test chromosome."]
    if accession:
        lines.append(f"ACCESSION   {accession}")
    if organism:
        lines += [f"SOURCE      {organism}", f"  ORGANISM  {organism}"]
    lines += ["FEATURES             Location/Qualifiers", f"     source          1..{len(seq)}"]
    for loc, i in features:
        lines += [f"     CDS             {loc}", f'                     /locus_tag="{locus}_{i:04d}"',
                  f'                     /product="protein {i} of a test',
                  '                     genome"']
    lines.append("ORIGIN")
    for off in range(0, len(seq), 60):
        row = seq[off:off + 60].lower()
        lines.append(f"{off + 1:9d} " + " ".join(row[j:j + 10] for j in range(0, len(row), 10)))
    return "\n".join(lines) + "\n//\n"


def write_genomes(tmp_path, seed=3, n_genomes=5, n_cds=8, **kw):
    rng = np.random.default_rng(seed)
    paths = []
    for g in range(0, n_genomes, 2):  # two records a file, the last file one
        text = ""
        for r in range(g, min(g + 2, n_genomes)):
            seq, feats, _ = genome_record(rng, n_cds=n_cds, **kw)
            text += gbff_text(f"LOC{r}", f"NZ_TEST{r:03d}.1", f"Genus{r % 3} species{r}",
                              seq, feats)
        path = tmp_path / f"GCF_{g:06d}_genomic.gbff"
        path.write_text(text)
        paths.append(path)
    return paths


def dataset_files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix in (".npz", ".npy", ".json", ".tsv", ".txt")}


def test_prepare_from_genbank_gives_the_jax_dataset(tmp_path):
    paths = write_genomes(tmp_path)
    kw = dict(block_size=64, skip_homology=True, split_seed=5)
    got = pipeline.prepare_from_genbank(paths, tmp_path / "port", **kw)
    want = jax_pipeline.prepare_from_genbank(paths, tmp_path / "jax", **kw)
    assert got["dataset"]["id"] == want["dataset"]["id"]
    files = dataset_files(tmp_path / "port")
    assert files == dataset_files(tmp_path / "jax")
    assert sum(name.endswith(".npz") for name in files) == 3
    assert got["split_policy"]["record_counts"]["test"] > 0


def wait_for_jax_library() -> None:
    """Load the JAX package's native library, not its Python fallback.

    JAX builds it at first use with ``make -B``, which rewrites the file in
    place, so a process that loads it while another process's build is
    writing it gets a broken file and falls back to Python. When the library
    is missing or older than its source, it is built here first, with JAX's
    Makefile flags, into a temporary file moved into place whole; JAX then
    finds it current and builds nothing. A build of JAX's own tests that is
    writing at that moment is waited out."""
    lib = Path(jax_native._LIB_PATH)
    src = lib.with_name("genomics_native.cpp")
    if not lib.exists() or src.stat().st_mtime > lib.stat().st_mtime:
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", str(src),
                        "-o", str(tmp)], check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
    for _ in range(40):
        if jax_native.available():
            return
        time.sleep(0.25)
    assert jax_native.available(), "the JAX package's native library did not load"


def test_native_homology_audit_gives_the_jax_dataset(tmp_path):
    wait_for_jax_library()
    paths = write_genomes(tmp_path, seed=4, paralog_every=3)
    kw = dict(block_size=64, skip_homology=False, audit_engine="native", split_seed=5)
    got = pipeline.prepare_from_genbank(paths, tmp_path / "port", **kw)
    want = jax_pipeline.prepare_from_genbank(paths, tmp_path / "jax", **kw)
    assert got["dataset"]["id"] == want["dataset"]["id"]
    assert dataset_files(tmp_path / "port") == dataset_files(tmp_path / "jax")
    report = json.loads((tmp_path / "port" / "leakage_audit.json").read_text())
    homology = report["protein_homology"]
    assert report["engine"] == "native" and report["status"] == "passed"
    assert homology["tool"] == {"name": "genomics_native_minhash", "engine": "native"}
    # the paralogs cluster: fewer clusters than records
    assert homology["cluster_count"] < report["record_count"]
    assert not got["dataset"]["scientific_valid"]
    # the CLI: the same id
    args = ["--gbff", *map(str, paths), "--block_size", "64", "--split_seed", "5",
            "--audit_engine", "native", "--out_dir", str(tmp_path / "cli")]
    assert prepare_cli(args) == 0
    assert (json.loads((tmp_path / "cli" / "manifest.json").read_text())["dataset"]["id"]
            == want["dataset"]["id"])


def test_native_audit_reports_the_jax_clusters_across_splits(tmp_path):
    """Near-duplicates placed in different splits: under the ``report``
    policy both reports list the same cross-split clusters; under ``block``
    both fail closed with the report written."""
    wait_for_jax_library()
    rng = np.random.default_rng(9)
    _, _, genes = genome_record(rng, n_cds=24, paralog_every=2)
    rows = [{"sequence": g, "source_id": f"g{i}", "split": ("train", "val", "test")[i % 3]}
            for i, g in enumerate(genes)]
    reports = {}
    for side, lib in (("port", leakage), ("jax", jax_leakage)):
        reports[side] = lib.audit_source_records(
            rows, tmp_path / side / "audit.json", engine="native",
            protein_homology_policy="report")
    assert reports["port"] == reports["jax"]
    assert reports["port"]["protein_homology"]["cross_split_cluster_count"] > 0
    errors = {}
    for side, lib in (("port", leakage), ("jax", jax_leakage)):
        with pytest.raises(lib.LeakageAuditError) as info:
            lib.audit_source_records(rows, tmp_path / side / "block.json", engine="native")
        errors[side] = (str(info.value), (tmp_path / side / "block.json").read_bytes())
    assert errors["port"] == errors["jax"]


def test_genus_precedence_is_jax_s(tmp_path, monkeypatch):
    """``(genus_of.get(...) or organism.split()[0]) if organism else ""``:
    a record without an organism gets no genus even when ``genus_of`` names
    one."""
    rng = np.random.default_rng(6)
    text = ""
    for r, organism in enumerate(("Alpha beta", None, "Gamma delta")):
        seq, feats, _ = genome_record(rng, n_cds=2)
        text += gbff_text(f"LOC{r}", f"ACC{r}", organism, seq, feats)
    path = tmp_path / "g.gbff"
    path.write_text(text)
    seen = {}
    for side, lib in (("port", pipeline), ("jax", jax_pipeline)):
        monkeypatch.setattr(lib, "prepare_dataset",
                            lambda records, out_dir, side=side, **kw: seen.setdefault(side, records))
        lib.prepare_from_genbank([path], tmp_path / side, genus_of={"ACC1": "Named", "ACC2": "Mapped"})
    assert seen["port"] == seen["jax"]
    genus = {r["genome"]: r["genus"] for r in seen["port"]}
    assert genus == {"ACC0": "Alpha", "ACC1": "", "ACC2": "Mapped"}
