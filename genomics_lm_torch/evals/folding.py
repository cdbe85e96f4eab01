"""Structure-confidence scoring: ESMFold API client + deterministic mock (a
copy of ``genomics_lm_tpu/evals/folding.py``).

The reference submits candidate proteins to the public ESMFold API and
reports per-residue pLDDT statistics (``scripts/generative_design_loop.py``
step 5, ``scripts/submit_esmfold_from_csv.py``). This module provides the
same capability as a library:

- ``fold_api``  — POST to the ESMFold endpoint, parse CA-atom b-factors,
- ``fold_mock`` — a deterministic, network-free stand-in whose pLDDT is a
  seeded function of the sequence (sha256) plus simple composition
  heuristics, emitting a minimal valid PDB. Tests and offline runs use it.
- ``fold_sequences`` — batch folding with on-disk PDB caching and backend
  selection.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Sequence

import numpy as np

ESMFOLD_URL = "https://api.esmatlas.com/foldSequence/v1/pdb/"

# residues that tend to sit in ordered secondary structure vs disorder
_ORDER_PRONE = set("ILVFWYMC")
_DISORDER_PRONE = set("PGSQEKR")


def plddt_from_pdb(pdb_text: str) -> dict | None:
    """pLDDT stats from the b-factor column of CA atoms."""
    values = []
    for line in pdb_text.splitlines():
        if line.startswith("ATOM") and " CA " in line and len(line) >= 66:
            try:
                values.append(float(line[60:66]))
            except ValueError:
                continue
    if not values:
        return None
    arr = np.asarray(values)
    return {
        "plddt_mean": float(arr.mean()),
        "plddt_min": float(arr.min()),
        "plddt_max": float(arr.max()),
    }


def fold_api(sequence: str, *, timeout: float = 45.0) -> dict | None:
    """Fold via the public ESMFold endpoint; None on any failure."""
    import urllib.request

    try:
        req = urllib.request.Request(
            ESMFOLD_URL, data=sequence.encode(), method="POST",
            headers={"Content-Type": "application/x-www-form-urlencoded"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            pdb_text = resp.read().decode()
    except Exception:
        return None
    stats = plddt_from_pdb(pdb_text)
    if stats is None:
        return None
    return {**stats, "pdb_text": pdb_text}


def _mock_residue_plddt(sequence: str) -> np.ndarray:
    """Deterministic per-residue pLDDT: a seeded random walk shaped by
    residue composition (order-prone residues score higher)."""
    seed = int.from_bytes(hashlib.sha256(sequence.encode()).digest()[:4], "big")
    rng = np.random.default_rng(seed)
    base = 55.0 + 25.0 * rng.random()
    scores = np.empty(len(sequence))
    level = base
    for i, aa in enumerate(sequence):
        if aa in _ORDER_PRONE:
            level += 1.5
        elif aa in _DISORDER_PRONE:
            level -= 1.2
        level += rng.normal(0.0, 2.0)
        level = float(np.clip(level, 20.0, 98.0))
        scores[i] = level
    # termini are usually less confident
    taper = min(5, len(sequence) // 4)
    for i in range(taper):
        scores[i] -= (taper - i) * 2.0
        scores[-1 - i] -= (taper - i) * 2.0
    return np.clip(scores, 10.0, 99.0)


def fold_mock(sequence: str, **_ignored) -> dict | None:
    """Network-free deterministic fold result with a minimal CA-trace PDB."""
    if not sequence:
        return None
    plddt = _mock_residue_plddt(sequence)
    lines = ["REMARK  MOCK ESMFOLD (deterministic, offline)"]
    for i, (aa, score) in enumerate(zip(sequence, plddt), start=1):
        lines.append(
            f"ATOM  {i:5d}  CA  ALA A{i:4d}    "
            f"{float(i):8.3f}{0.0:8.3f}{0.0:8.3f}{1.00:6.2f}{score:6.2f}           C"
        )
    lines.append("END")
    return {
        "plddt_mean": float(plddt.mean()),
        "plddt_min": float(plddt.min()),
        "plddt_max": float(plddt.max()),
        "pdb_text": "\n".join(lines) + "\n",
    }


BACKENDS = {"api": fold_api, "mock": fold_mock}


def fold_sequences(
    entries: Sequence[tuple[str, str]],
    *,
    backend: str = "api",
    out_dir: str | Path | None = None,
    timeout: float = 45.0,
) -> dict[str, dict]:
    """Fold (name, sequence) pairs; returns name → pLDDT stats (+pdb path).

    Results are written as ``<out_dir>/<name>.pdb`` when ``out_dir`` is
    given; an existing PDB short-circuits the fold (cache)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown fold backend {backend!r}; use {sorted(BACKENDS)}")
    fold = BACKENDS[backend]
    results: dict[str, dict] = {}
    target = Path(out_dir) if out_dir else None
    if target:
        target.mkdir(parents=True, exist_ok=True)
    for name, seq in entries:
        pdb_path = target / f"{name}.pdb" if target else None
        if pdb_path and pdb_path.exists():
            cached = plddt_from_pdb(pdb_path.read_text())
            if cached:
                results[name] = {**cached, "pdb": str(pdb_path), "cached": True}
                continue
        outcome = fold(seq, timeout=timeout)
        if outcome is None:
            continue
        record = {k: v for k, v in outcome.items() if k != "pdb_text"}
        if pdb_path:
            pdb_path.write_text(outcome["pdb_text"])
            record["pdb"] = str(pdb_path)
        results[name] = record
    return results


__all__ = [
    "BACKENDS",
    "ESMFOLD_URL",
    "fold_api",
    "fold_mock",
    "fold_sequences",
    "plddt_from_pdb",
]
