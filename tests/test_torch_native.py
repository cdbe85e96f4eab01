"""The port's native host library (``genomics_lm_torch/native``) against its
plain versions and the JAX package's library.

- Each entry point equals its plain version exactly: codon ids, reverse
  complements, SHA-256 digests and minhash cluster labels on random protein
  sets from a numpy seed, sets near the threshold included.
- Near the threshold the estimate (64 minhash agreements) and the exact
  shingle Jaccard of JAX's pure-Python fallback (``_minhash_cluster_py``)
  cluster differently; the port keeps the estimate everywhere.
- The port's labels equal those of JAX's library (loaded, not its fallback).
- The library is the port's own build under ``kernels/_build``; a compiler
  that fails, or none, raises with its output or its name, and
  ``available()`` reports it without raising.
"""

from __future__ import annotations

import hashlib
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genomics_lm_tpu import native as jax_native
from genomics_lm_torch import native
from genomics_lm_torch.kernels import build as build_lib
from tests.test_torch_genbank import wait_for_jax_library

REPO = Path(__file__).resolve().parent.parent
AMINO = list("ACDEFGHIKLMNPQRSTVWY")


def mutated(rng, seq: str, rate: float) -> str:
    s = np.array(list(seq))
    hit = rng.random(len(s)) < rate
    s[hit] = rng.choice(AMINO, int(hit.sum()))
    return "".join(s)


def protein_set(rng, n_families: int, members: int, rate: float) -> list[str]:
    seqs = []
    for _ in range(n_families):
        base = "".join(rng.choice(AMINO, int(rng.integers(30, 200))))
        seqs += [base] + [mutated(rng, base, rate) for _ in range(members - 1)]
    order = rng.permutation(len(seqs))
    return [seqs[i] for i in order]


def exact_jaccard(a: str, b: str, k: int) -> float:
    sa = {a[i:i + k] for i in range(max(0, len(a) - k + 1))}
    sb = {b[i:i + k] for i in range(max(0, len(b) - k + 1))}
    return len(sa & sb) / len(sa | sb) if sa | sb else 1.0


@pytest.mark.parametrize("k,n_hashes,min_jaccard,rate", [
    (5, 64, 0.5, 0.05), (4, 64, 0.176, 0.15), (3, 128, 0.3, 0.1), (4, 32, 0.5, 0.08),
])
def test_library_equals_its_plain_version_and_jax_s_library(k, n_hashes, min_jaccard, rate):
    wait_for_jax_library()
    rng = np.random.default_rng(int(1000 * min_jaccard) + k)
    for trial in range(4):
        seqs = protein_set(rng, 8, 5, rate) + ["", "MK", "MKVL", "MKVLÅ"]
        got = native.minhash_cluster(seqs, k=k, n_hashes=n_hashes, min_jaccard=min_jaccard)
        want = native.minhash_cluster_reference(seqs, k=k, n_hashes=n_hashes,
                                                min_jaccard=min_jaccard)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jax_native.minhash_cluster(seqs, k=k, n_hashes=n_hashes,
                                            min_jaccard=min_jaccard))
        assert got.dtype == np.int32 and 1 < len(set(got.tolist())) < len(seqs)
    assert native.minhash_cluster([]).shape == (0,)
    proteins = {f"p{i}": s for i, s in enumerate(protein_set(rng, 5, 3, rate))}
    assert (native.native_protein_clusters(proteins, min_identity=0.4)
            == jax_native.native_protein_clusters(proteins, min_identity=0.4))


def test_estimate_and_exact_jaccard_disagree_near_the_threshold():
    """Pairs whose exact 4-mer Jaccard straddles 0.5: the library's labels
    are the plain estimate's, and on some pair the JAX fallback's exact
    Jaccard clusters otherwise."""
    rng = np.random.default_rng(21)
    disagreements = 0
    for _ in range(60):
        base = "".join(rng.choice(AMINO, 120))
        pair = [base, mutated(rng, base, 0.09)]
        got = native.minhash_cluster(pair, k=4, min_jaccard=0.5)
        np.testing.assert_array_equal(
            got, native.minhash_cluster_reference(pair, k=4, min_jaccard=0.5))
        exact = jax_native._minhash_cluster_py(pair, 4, 64, 0.5)
        assert (exact[1] == 0) == (exact_jaccard(*pair, 4) >= 0.5)
        disagreements += int(exact[1] != got[1])
    assert disagreements > 0


def test_codons_reverse_complement_and_sha256_equal_the_plain_versions():
    wait_for_jax_library()
    rng = np.random.default_rng(5)
    alphabet = list("ACGTUacgtuNRYn-") + ["é"]
    for n in (0, 1, 2, 3, 4, 5, 299, 300, 1001):
        for _ in range(3):
            dna = "".join(rng.choice(alphabet, n, p=None))
            ids = native.tokenize_codons(dna)
            np.testing.assert_array_equal(ids, native.tokenize_codons_reference(dna))
            np.testing.assert_array_equal(ids, jax_native.tokenize_codons(dna))
            assert native.reverse_complement(dna) == native.reverse_complement_reference(dna)
            assert native.reverse_complement(dna) == jax_native.reverse_complement(dna)
            data = dna.encode("utf-8")
            assert native.sha256_hex(data) == native.sha256_hex_reference(data)
            assert native.sha256_hex(data) == hashlib.sha256(data).hexdigest()
    assert native.tokenize_codons("AUGaugATGNNN").tolist() == [18, 18, 18, -1]
    assert native.reverse_complement("TTACAT") == "ATGTAA"


def test_the_port_loads_its_own_build():
    code = (
        "from genomics_lm_torch import native\n"
        "native.minhash_cluster(['MKVLAAG', 'MKVLAAG'])\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(str(native.library_path()) in maps, 'genomics_lm_tpu' in maps,\n"
        "      'libgenomics_native.so' in maps)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "False", "False"]
    assert native.library_path().parent == build_lib.BUILD_DIR
    assert native.library_path().name.startswith("libgenomics_native-")


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no loaded library; restored after."""
    monkeypatch.setattr(build_lib, "BUILD_DIR", tmp_path / "_build")
    native._load.cache_clear()
    yield tmp_path
    native._load.cache_clear()


def test_a_failed_build_raises_with_the_compiler_output(fresh_build, monkeypatch):
    compiler = fresh_build / "failing-g++"
    compiler.write_text("#!/bin/sh\necho 'genomics_native.cpp:1: error: simulated' >&2\nexit 1\n")
    compiler.chmod(compiler.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(compiler))
    assert native.available() is False
    with pytest.raises(RuntimeError, match="simulated") as info:
        native.minhash_cluster(["MKVLAAG"])
    assert "exited 1" in str(info.value)
    assert not list((fresh_build / "_build").glob("*.so"))
    for fn, arg in ((native.tokenize_codons, "ATG"), (native.reverse_complement, "ATG"),
                    (native.sha256_hex, b"x")):
        with pytest.raises(RuntimeError, match="simulated"):
            fn(arg)


def test_a_missing_compiler_raises_and_names_it(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", "g++-absent-for-this-test")
    assert native.available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+-absent-for-this-test not found"):
        native.sha256_hex(b"x")


def test_a_native_audit_without_a_library_fails_closed(fresh_build, monkeypatch, tmp_path):
    from genomics_lm_torch.data import leakage

    monkeypatch.setenv("CXX", "g++-absent-for-this-test")
    rows = [{"sequence": "ATGAAACCCGGGTTTTAA", "source_id": "a", "split": "train"},
            {"sequence": "ATGCCCAAAGGGTTTTAG", "source_id": "b", "split": "test"}]
    with pytest.raises(leakage.LeakageAuditError, match="native homology tool"):
        leakage.audit_source_records(rows, tmp_path / "audit.json", engine="native")
    report = (tmp_path / "audit.json").read_text()
    assert '"status": "error"' in report and "not found" in report


def test_jax_s_fallbacks_against_the_library(monkeypatch):
    """Where JAX's pure-Python fallbacks (used when its library is missing)
    differ from the C++ the port keeps: the reverse complement of a
    non-ASCII character (kept as is, where the library reads ``?``) and the
    minhash clusters (above); the codon ids and digests agree."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    assert jax_native.reverse_complement("ATGé") == "éCAT"
    assert native.reverse_complement("ATGé") == "?CAT"
    assert jax_native.reverse_complement("ATGCNn") == native.reverse_complement("ATGCNn")
    for dna in ("AUGaugATGNNNRTGé", "ACGTTGCA" * 9):
        np.testing.assert_array_equal(jax_native.tokenize_codons(dna),
                                      native.tokenize_codons(dna))
    assert jax_native.sha256_hex(b"abc") == native.sha256_hex(b"abc")
