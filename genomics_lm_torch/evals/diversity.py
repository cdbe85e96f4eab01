"""Sequence-diversity metrics for generated designs: a numpy copy of
``genomics_lm_tpu/evals/diversity.py``.

Behavioral spec (reference ``src/eval/diversity.py``): sampled average
pairwise identity over min-length prefixes, k-mer coverage of the 20^k
amino-acid space, and per-sequence GC fraction. Implemented vectorized over
byte arrays rather than per-character Python loops.
"""

from __future__ import annotations

import random

import numpy as np

AMINO_ALPHABET_SIZE = 20


def _as_bytes(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)


def pairwise_identity(seqs: list[str], max_pairs: int = 500, seed: int | None = None) -> float:
    """Mean fraction of identical positions over sampled sequence pairs.

    Each pair is compared over its shorter member's length; zero-length
    pairs are dropped. With more than ``max_pairs`` candidate pairs, a
    uniform sample (seedable) is scored instead of the full quadratic set.
    """
    n = len(seqs)
    if n < 2:
        return 1.0
    all_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    if len(all_pairs) > max_pairs:
        all_pairs = random.Random(seed).sample(all_pairs, max_pairs)
    encoded = [_as_bytes(s) for s in seqs]
    scores = []
    for i, j in all_pairs:
        a, b = encoded[i], encoded[j]
        m = min(a.size, b.size)
        if m:
            scores.append(float(np.count_nonzero(a[:m] == b[:m])) / m)
    return float(np.mean(scores)) if scores else 0.0


def kmer_diversity(seqs: list[str], k: int = 3) -> float:
    """Observed distinct k-mers as a fraction of the 20^k amino-acid space."""
    seen: set[str] = set()
    for seq in seqs:
        seen.update(seq[i : i + k] for i in range(len(seq) - k + 1))
    return len(seen) / float(AMINO_ALPHABET_SIZE**k)


def gc_content(codon_seqs: list[list[str]]) -> list[float]:
    """G+C fraction of each codon list's concatenated DNA (0.0 if empty)."""
    out: list[float] = []
    for codons in codon_seqs:
        joined = "".join(codons).upper()
        out.append(
            (joined.count("G") + joined.count("C")) / len(joined) if joined else 0.0
        )
    return out


__all__ = ["AMINO_ALPHABET_SIZE", "gc_content", "kmer_diversity", "pairwise_identity"]
