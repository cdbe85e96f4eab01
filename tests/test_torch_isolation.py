"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

A fresh interpreter imports every module of ``genomics_lm_torch`` and the
``chip_smoke`` script and finds neither ``jax``, ``genomics_lm_tpu`` nor the
JAX package's ``scripts`` in ``sys.modules``; a source scan finds no import
of any of them, static or dynamic (docstrings may still name the JAX twin
of a module). The port's copy of the codon vocabulary equals the JAX
package's.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "genomics_lm_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


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
