"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

A fresh interpreter imports every module of ``genomics_lm_torch`` and the
``chip_smoke`` script and finds neither ``jax``, ``genomics_lm_tpu`` nor the
JAX package's ``scripts`` in ``sys.modules``; a source scan finds no import
of any of them, static or dynamic (docstrings may still name the JAX twin
of a module). No port source names a path under ``genomics_lm_tpu/`` or
the JAX package's ``libgenomics_native.so`` outside its docstrings and
comments, apart from the ``file:line`` citations of the kernels each port
kernel replaces. The port's copy of the codon vocabulary equals the JAX
package's.
"""

from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "genomics_lm_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
NATIVE_SOURCES = sorted(p for ext in ("*.cu", "*.cuh", "*.cpp", "*.h") for p in PORT.rglob(ext))
CITATION = re.compile(r"^genomics_lm_tpu/[\w/]+\.py:\d*$")  # "replaces": file:line, never opened


def jax_paths_named(text: str) -> list[str]:
    """The non-docstring string constants of a Python source that name the JAX
    package's files, citations aside."""
    tree = ast.parse(text)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs
            and ("libgenomics_native" in node.value
                 or ("genomics_lm_tpu" in node.value and not CITATION.match(node.value)))]


def test_importing_the_port_pulls_in_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'genomics_lm_tpu', 'scripts'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_neither_jax_nor_the_jax_package():
    static = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|genomics_lm_tpu|scripts)\b", re.M)
    dynamic = re.compile(r"(import_module|__import__)\(\s*[\"'](jax|genomics_lm_tpu|scripts)")
    offenders = [str(p.relative_to(REPO)) for p in PORT_SOURCES
                 if static.search(p.read_text()) or dynamic.search(p.read_text())]
    assert not offenders


def test_vocabulary_copy_matches_the_jax_package():
    from genomics_lm_tpu.tokenizers import codon as jax_codon
    from genomics_lm_torch.tokenizers import codon

    assert codon.VOCAB == jax_codon.VOCAB and codon.stoi == jax_codon.stoi
    assert (codon.PAD_ID, codon.BOS_ID, codon.EOS_ID, codon.SEP_ID) == (
        jax_codon.PAD_ID, jax_codon.BOS_ID, jax_codon.EOS_ID, jax_codon.SEP_ID)
    assert codon.STOP_IDS == jax_codon.STOP_IDS
    rng = np.random.default_rng(0)
    dna = "".join(rng.choice(list("ACGT"), 60))
    for term in ("eos", "sep", "none"):
        assert codon.to_ids(dna, term) == jax_codon.to_ids(dna, term)
    assert codon.decode_ids(codon.to_ids(dna)) == jax_codon.decode_ids(jax_codon.to_ids(dna))
    for bad in ("ATGNNN", "ATGA"):
        try:
            jax_codon.to_ids(bad)
            want = None
        except ValueError as e:
            want = type(e).__name__
        try:
            codon.to_ids(bad)
            got = None
        except ValueError as e:
            got = type(e).__name__
        assert got == want


def test_no_source_names_a_path_of_the_jax_package():
    assert sorted(jax_paths_named(
        'from pathlib import Path\n'
        'LIB = Path(__file__).parent.parent / "genomics_lm_tpu" / "native"\n'
        'SO = "libgenomics_native.so"\n')) == ["genomics_lm_tpu", "libgenomics_native.so"]
    offenders = {str(p.relative_to(REPO)): named for p in PORT_SOURCES
                 if (named := jax_paths_named(p.read_text()))}
    assert not offenders
    comment = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
    offenders = [str(p.relative_to(REPO)) for p in NATIVE_SOURCES
                 if re.search(r"genomics_lm_tpu|libgenomics_native",
                              comment.sub("", p.read_text()))]
    assert NATIVE_SOURCES and not offenders
