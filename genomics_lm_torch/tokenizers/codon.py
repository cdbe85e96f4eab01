"""Codon tokenizer: the 68-token id contract, single-CDS encode/decode and
ambiguity-aware fragmenting.

The port's own copy of ``genomics_lm_tpu/tokenizers/codon.py`` (``VOCAB``
and the ids, ``to_ids``, ``decode_ids``, ``write_itos``,
``tokenize_cds_fragments`` and ``tokenize_file``):

    0: <PAD>   1: <BOS_CDS>   2: <EOS_CDS>   3: <SEP>
    4..67: the 64 codons AAA..TTT in lexical (A<C<G<T) order

The ids are a frozen public contract shared with the reference tokenizer
(``src/codonlm/codon_tokenize.py:29-44``); ``tests/test_torch_isolation.py``
holds this copy equal to the JAX package's. Ambiguous (IUPAC) codons split
a CDS into fragments rather than being dropped, with the same fragments,
coordinates and counters as JAX's (``tests/test_torch_data_pipeline.py``).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
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

IUPAC_DNA_BASES = frozenset("ACGTRYSWKMBDHVN")
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


@dataclass(frozen=True)
class TokenizedCDSFragment:
    """A retained contiguous run of unambiguous codons (oriented CDS coords)."""

    ids: list[int]
    source_id: str | None
    fragment_index: int
    codon_start: int
    codon_end: int
    base_start: int
    base_end: int


@dataclass(frozen=True)
class CDSTokenizationResult:
    """Fragments plus audit counters from ambiguity-aware tokenization."""

    fragments: list[TokenizedCDSFragment]
    ambiguous_codons: int
    discarded_fragments: int
    partial_trailing_bases: int

    @property
    def source_had_ambiguity(self) -> bool:
        return self.ambiguous_codons > 0


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


def _strip(dna: str) -> str:
    return dna.strip()


def _terminated(codon_ids: list[int], termination: str) -> list[int]:
    out = [BOS_ID, *codon_ids]
    if termination == "eos":
        out.append(EOS_ID)
    elif termination == "sep":
        out.append(SEP_ID)
    elif termination != "none":
        raise ValueError(f"Unsupported termination policy: {termination!r}")
    return out


def tokenize_cds_fragments(
    dna: str,
    *,
    source_id: str | None = None,
    min_fragment_codons: int = 1,
    termination: str = "eos",
) -> CDSTokenizationResult:
    """Split a CDS at ambiguous codons, never creating cross-gap adjacency.

    Coordinates are zero-based half-open offsets in the oriented CDS string;
    a trailing partial codon is excluded and reported via
    ``partial_trailing_bases``. A run shorter than ``min_fragment_codons``
    is discarded but still takes a fragment index.
    """
    if min_fragment_codons < 1:
        raise ValueError("min_fragment_codons must be at least 1")

    ids, trailing = _codon_ids_array(_strip(dna))
    ambiguous_mask = ids < 0
    fragments: list[TokenizedCDSFragment] = []
    discarded = 0
    fragment_index = 0
    if len(ids):
        # contiguous runs of valid codons, split at each ambiguous codon
        run_edges = np.concatenate([[-1], np.flatnonzero(ambiguous_mask), [len(ids)]])
        for left, right in zip(run_edges[:-1], run_edges[1:]):
            start, end = int(left) + 1, int(right)
            if end <= start:
                continue  # empty run (leading, trailing or consecutive ambiguity)
            if end - start >= min_fragment_codons:
                fragments.append(TokenizedCDSFragment(
                    ids=_terminated([int(t) for t in ids[start:end]], termination),
                    source_id=source_id, fragment_index=fragment_index,
                    codon_start=start, codon_end=end,
                    base_start=start * 3, base_end=end * 3))
            else:
                discarded += 1
            fragment_index += 1
    return CDSTokenizationResult(
        fragments=fragments,
        ambiguous_codons=int(ambiguous_mask.sum()),
        discarded_fragments=discarded,
        partial_trailing_bases=trailing,
    )


def to_ids(dna: str, termination: str = "eos") -> list[int]:
    """Encode one in-frame CDS into ids, failing closed on any ambiguity.

    Raises ``AmbiguousCodonError`` on an ambiguous full or partial trailing
    codon; returns ``[]`` for sequences shorter than one codon.
    """
    dna = _strip(dna)
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


TOKENIZE_STATS_KEYS = ("source_records", "source_records_with_ambiguity", "ambiguous_codons",
                       "retained_fragments", "discarded_fragments", "partial_trailing_bases")
FRAGMENT_FIELDS = ["fragment_line_idx", "source_line_idx", "source_id", "fragment_index",
                   "codon_start", "codon_end", "base_start", "base_end"]


def add_fragment_stats(stats: dict, result: CDSTokenizationResult) -> None:
    """Count one source record's tokenization into ``stats`` (all but
    ``retained_fragments``, which the caller counts as it writes)."""
    stats["source_records"] += 1
    stats["source_records_with_ambiguity"] += int(result.source_had_ambiguity)
    stats["ambiguous_codons"] += result.ambiguous_codons
    stats["discarded_fragments"] += result.discarded_fragments
    stats["partial_trailing_bases"] += result.partial_trailing_bases


def tokenize_file(
    inp: str | Path,
    out_ids: str | Path,
    out_vocab: str | Path | None = None,
    out_itos: str | Path | None = None,
    out_fragments: str | Path | None = None,
    *,
    min_fragment_codons: int = 10,
    termination: str = "eos",
) -> dict:
    """CDS-per-line file → id lines, vocab, and a fragment-provenance TSV;
    returns the stats dict (the reference ``codon_tokenize.main``'s keys
    and TSV schema)."""
    ids_path = Path(out_ids)
    ids_path.parent.mkdir(parents=True, exist_ok=True)
    fragments_path = Path(out_fragments or f"{out_ids}.fragments.tsv")
    fragments_path.parent.mkdir(parents=True, exist_ok=True)
    stats = dict.fromkeys(TOKENIZE_STATS_KEYS, 0)
    with (
        open(inp) as fin,
        open(ids_path, "w") as fout,
        open(fragments_path, "w", newline="") as fragment_handle,
    ):
        writer = csv.DictWriter(fragment_handle, fieldnames=FRAGMENT_FIELDS, delimiter="\t")
        writer.writeheader()
        for source_line_idx, line in enumerate(fin):
            source_id = f"line:{source_line_idx}"
            result = tokenize_cds_fragments(line, source_id=source_id,
                                            min_fragment_codons=min_fragment_codons,
                                            termination=termination)
            add_fragment_stats(stats, result)
            for fragment in result.fragments:
                fout.write(" ".join(map(str, fragment.ids)) + "\n")
                writer.writerow({
                    "fragment_line_idx": stats["retained_fragments"],
                    "source_line_idx": source_line_idx,
                    "source_id": source_id,
                    "fragment_index": fragment.fragment_index,
                    "codon_start": fragment.codon_start,
                    "codon_end": fragment.codon_end,
                    "base_start": fragment.base_start,
                    "base_end": fragment.base_end,
                })
                stats["retained_fragments"] += 1
    if out_vocab is not None:
        with open(out_vocab, "w") as f:
            for i, tok in enumerate(VOCAB):
                f.write(f"{i}\t{tok}\n")
    if out_itos is not None:
        write_itos(out_itos)
    return stats


__all__ = [
    "ALIASES",
    "AmbiguousCodonError",
    "BOS_ID",
    "CDSTokenizationResult",
    "CODONS",
    "CODON_BASE_ID",
    "EOS_ID",
    "FRAGMENT_FIELDS",
    "IUPAC_DNA_BASES",
    "PAD_ID",
    "SEP_ID",
    "SPECIALS",
    "STOP_CODONS",
    "STOP_IDS",
    "TOKENIZE_STATS_KEYS",
    "TokenizedCDSFragment",
    "VOCAB",
    "add_fragment_stats",
    "decode_ids",
    "itos",
    "stoi",
    "to_ids",
    "tokenize_cds_fragments",
    "tokenize_file",
    "write_itos",
]
