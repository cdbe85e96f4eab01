"""Codon vocabulary: the 68-token id contract and single-CDS encode/decode.

The port's own copy of the part of ``genomics_lm_tpu/tokenizers/codon.py``
that serving and training need (``VOCAB`` and the ids, ``to_ids``,
``decode_ids``, ``write_itos``):

    0: <PAD>   1: <BOS_CDS>   2: <EOS_CDS>   3: <SEP>
    4..67: the 64 codons AAA..TTT in lexical (A<C<G<T) order

The ids are a frozen public contract shared with the reference tokenizer
(``src/codonlm/codon_tokenize.py:29-44``); ``tests/test_torch_isolation.py``
holds this copy equal to the JAX package's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CODONS = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"]
SPECIALS = ["<PAD>", "<BOS_CDS>", "<EOS_CDS>", "<SEP>"]
VOCAB = SPECIALS + CODONS

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
SEP_ID = 3
CODON_BASE_ID = len(SPECIALS)  # first codon id (= 4)

STOP_CODONS = {"TAA", "TAG", "TGA"}

stoi = {tok: i for i, tok in enumerate(VOCAB)}
itos = {i: tok for i, tok in enumerate(VOCAB)}

# Legacy aliases accepted on encode only (reference codon_tokenize.py:38-44).
ALIASES = {"<bos>": "<BOS_CDS>", "<eog>": "<EOS_CDS>", "<eos>": "<EOS_CDS>"}
for _alias, _canonical in ALIASES.items():
    stoi[_alias] = stoi[_canonical]

STOP_IDS = tuple(stoi[c] for c in sorted(STOP_CODONS))

# Byte-value lookup: 'A'→0 'C'→1 'G'→2 'T'→3 (and U as T), else 255.
_BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_LUT[_b] = _i
_BASE_LUT[ord("U")] = 3
for _i, _b in enumerate(b"acgt"):
    _BASE_LUT[_b] = _i
_BASE_LUT[ord("u")] = 3


class AmbiguousCodonError(ValueError):
    """Raised when single-sequence tokenization would erase an ambiguous codon."""


def _codon_ids_array(dna: str) -> tuple[np.ndarray, int]:
    """DNA → per-codon ids (ambiguous codons are -1) and the trailing base count."""
    raw = np.frombuffer(dna.encode("ascii", errors="replace"), dtype=np.uint8)
    base = _BASE_LUT[raw]
    n_codons = len(base) // 3
    trailing = len(base) - n_codons * 3
    b = base[: n_codons * 3].reshape(n_codons, 3).astype(np.int32)
    ids = CODON_BASE_ID + b[:, 0] * 16 + b[:, 1] * 4 + b[:, 2]
    ambiguous = (b == 255).any(axis=1)
    return np.where(ambiguous, np.int32(-1), ids), trailing


def _terminated(codon_ids: list[int], termination: str) -> list[int]:
    out = [BOS_ID, *codon_ids]
    if termination == "eos":
        out.append(EOS_ID)
    elif termination == "sep":
        out.append(SEP_ID)
    elif termination != "none":
        raise ValueError(f"Unsupported termination policy: {termination!r}")
    return out


def to_ids(dna: str, termination: str = "eos") -> list[int]:
    """Encode one in-frame CDS into ids, failing closed on any ambiguity.

    Raises ``AmbiguousCodonError`` on an ambiguous full or partial trailing
    codon; returns ``[]`` for sequences shorter than one codon.
    """
    dna = dna.strip()
    if len(dna) < 3:
        return []
    ids, trailing = _codon_ids_array(dna)
    if trailing:
        tail = dna.upper().replace("U", "T")[len(dna) - trailing :]
        if not set(tail) <= set("ACGT"):
            raise AmbiguousCodonError(
                f"ambiguous partial codon {tail!r} at codon index {len(ids)}"
            )
    bad = np.flatnonzero(ids < 0)
    if bad.size:
        i = int(bad[0])
        codon = dna.upper().replace("U", "T")[i * 3 : i * 3 + 3]
        raise AmbiguousCodonError(f"ambiguous codon {codon!r} at codon index {i}")
    if not len(ids):
        return []
    return _terminated([int(t) for t in ids], termination)


def decode_ids(ids) -> str:
    """Token ids → DNA string, skipping special tokens."""
    return "".join(itos[int(i)] for i in ids if int(i) >= CODON_BASE_ID)


def write_itos(path: str | Path) -> None:
    """Write the canonical one-token-per-line itos file."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(VOCAB) + "\n")


__all__ = [
    "ALIASES",
    "AmbiguousCodonError",
    "BOS_ID",
    "CODONS",
    "CODON_BASE_ID",
    "EOS_ID",
    "PAD_ID",
    "SEP_ID",
    "SPECIALS",
    "STOP_CODONS",
    "STOP_IDS",
    "VOCAB",
    "decode_ids",
    "itos",
    "stoi",
    "to_ids",
    "write_itos",
]
