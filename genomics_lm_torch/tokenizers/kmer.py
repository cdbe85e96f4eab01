"""General k-mer tokenizer for DNA (not frame-dependent); the port's own
copy of ``genomics_lm_tpu/tokenizers/kmer.py``.

Parity: reference ``src/codonlm/kmer_tokenize.py`` — vocabulary is
``["<pad>", "<bos>", "<eos>", "<unk>"] + all 4^k k-mers`` (lexical order),
and encoding emits overlapping (stride-1) k-mers wrapped in bos/eos.
"""

from __future__ import annotations

from itertools import product

SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]


def build_vocab(k: int) -> list[str]:
    """Specials + every k-mer over ACGT in lexical order."""
    if k < 1:
        raise ValueError("k must be >= 1")
    return SPECIALS + ["".join(p) for p in product("ACGT", repeat=k)]


def build_stoi(k: int) -> dict[str, int]:
    return {tok: i for i, tok in enumerate(build_vocab(k))}


def to_ids(seq: str, k: int, stoi: dict[str, int]) -> list[int]:
    """Overlapping k-mer ids wrapped in <bos>/<eos>; unknowns → <unk>."""
    s = seq.strip().upper().replace("U", "T")
    ids = [stoi["<bos>"]]
    ids.extend(stoi.get(s[i : i + k], stoi["<unk>"]) for i in range(0, len(s) - k + 1))
    ids.append(stoi["<eos>"])
    return ids


def kmer_tokenize(seq: str, k: int = 3, stride: int | None = None) -> list[str]:
    """Split into k-mer strings (stride defaults to k: non-overlapping).

    Used by the k-mer TF-IDF baselines (reference
    ``src/classifiers/kmer_baselines.py``), which vectorize over k-mer
    string lists rather than ids.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    stride = k if stride is None else stride
    if stride < 1:
        raise ValueError("stride must be >= 1")
    seq = seq.strip().upper()
    return [seq[i : i + k] for i in range(0, len(seq) - k + 1, stride)]
