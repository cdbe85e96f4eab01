"""Structural termination-motif heuristics (hairpins, poly-T tracts): a
numpy copy of ``genomics_lm_tpu/evals/termination_motifs.py``.

Parity: reference ``scripts/check_termination_motifs.py:10-60`` /
``test_perturbation_motifs.py`` / ``test_utr_generation.py`` — heuristic
stem-loop stability scoring and poly-T run detection used to test whether the
LM associates rho-independent-terminator-like structure with stop placement.
"""

from __future__ import annotations

import numpy as np

PAIRS = {"A": "T", "T": "A", "G": "C", "C": "G"}
STOP_CODONS = {"TAA", "TAG", "TGA"}


def hairpin_score(dna: str, *, min_stem: int = 3, max_stem: int = 11,
                  min_loop: int = 3, max_loop: int = 9) -> float:
    """Best stem-loop score: +3 per G-C pair, +2 per A-T pair, −1 mismatch."""
    n = len(dna)
    best = 0.0
    for loop in range(min_loop, max_loop + 1):
        for i in range(n):
            for stem in range(min_stem, max_stem + 1):
                end = i + 2 * stem + loop
                if end > n:
                    break
                s1 = dna[i : i + stem]
                s2 = dna[i + stem + loop : end][::-1]
                score = 0
                for a, b in zip(s1, s2):
                    if PAIRS.get(a) == b:
                        score += 3 if a in "GC" else 2
                    else:
                        score -= 1
                if score > best:
                    best = float(score)
    return best


def max_poly_t_run(dna: str) -> int:
    """Longest consecutive T run (rho-independent terminator tail proxy)."""
    best = run = 0
    for c in dna:
        run = run + 1 if c == "T" else 0
        best = max(best, run)
    return best


def gc_fraction(dna: str) -> float:
    return sum(c in "GC" for c in dna) / max(len(dna), 1)


def terminal_window_contrast(
    sequences: list[str], *, window: int = 30, seed: int = 0
) -> dict:
    """Hairpin/poly-T scores in the window straddling the terminal stop vs a
    random interior window of the same width, per sequence."""
    rng = np.random.default_rng(seed)
    terminal, interior = [], []
    for dna in sequences:
        dna = dna.upper().replace("U", "T")
        if len(dna) < 2 * window:
            continue
        term_win = dna[-window:]
        lo = int(rng.integers(0, max(1, len(dna) - 2 * window)))
        int_win = dna[lo : lo + window]
        terminal.append({"hairpin": hairpin_score(term_win),
                         "poly_t": max_poly_t_run(term_win),
                         "gc": gc_fraction(term_win)})
        interior.append({"hairpin": hairpin_score(int_win),
                         "poly_t": max_poly_t_run(int_win),
                         "gc": gc_fraction(int_win)})

    def agg(rows, key):
        return float(np.mean([r[key] for r in rows])) if rows else None

    return {
        "sequences_scored": len(terminal),
        "terminal": {k: agg(terminal, k) for k in ("hairpin", "poly_t", "gc")},
        "interior": {k: agg(interior, k) for k in ("hairpin", "poly_t", "gc")},
        "hairpin_contrast": (
            agg(terminal, "hairpin") - agg(interior, "hairpin")
            if terminal else None
        ),
        "poly_t_contrast": (
            agg(terminal, "poly_t") - agg(interior, "poly_t")
            if terminal else None
        ),
    }


def synthetic_hairpin(stem: str = "GCCGCC", loop: str = "TTCG") -> str:
    """A strong GC stem-loop followed by a poly-T tail (terminator-like)."""
    complement = "".join(PAIRS[c] for c in reversed(stem))
    return stem + loop + complement + "TTTTTTT"


__all__ = [
    "STOP_CODONS",
    "gc_fraction",
    "hairpin_score",
    "max_poly_t_run",
    "synthetic_hairpin",
    "terminal_window_contrast",
]
