"""Lossless token chunking and auditable multi-window packing.

A verbatim copy of ``genomics_lm_tpu/data/packing.py`` (pure numpy), kept
here because the port never imports the JAX package. The windows, arrays
and metadata rows are a cross-framework data contract:
``tests/test_torch_data.py`` holds the two copies to identical output.

Behavioral spec (reference ``src/codonlm/lossless_packing.py``), kept
semantically identical because the on-disk arrays and metadata tables are a
cross-framework data contract:

- a fragment splits into chunks of at most ``block_size + 1`` tokens with a
  **one-token overlap**, so every next-token transition of the source lands
  in exactly one chunk (the manifest's ``exactly_once`` transition policy);
- ``single``/``dynamic`` packing keeps one chunk per window; ``multi`` packs
  several complete CDS chunks per window separated by ``sep_id``, and any
  continuation chunk (either side of an overlap) gets a window of its own so
  the overlap token never duplicates a transition across a separator;
- fixed-mode arrays are shifted X/Y ``(N, block_size)`` int32 matrices
  (TPU-friendly static shapes); dynamic mode emits a flat token stream plus
  per-window lengths; both carry aligned ``segment_ids`` /
  ``source_positions`` / ``chunk_ids`` provenance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Mapping

import numpy as np

# column order of the packing-metadata table (cross-framework contract)
PACKING_METADATA_FIELDS = [
    "split", "window_index", "window_token_count",
    "window_token_start", "window_token_end",
    "source_id", "source_line_idx", "fragment_line_idx", "fragment_index",
    "chunk_index", "source_token_start", "source_token_end",
    "codon_start", "codon_end",
    "continues_from_previous", "continues_to_next",
    "starts_fragment", "ends_fragment",
]


@dataclass(frozen=True)
class TokenChunk:
    """One transition-complete chunk derived from a tokenized CDS fragment."""

    tokens: tuple[int, ...]
    source_id: str
    source_line_idx: int
    fragment_line_idx: int
    fragment_index: int
    chunk_index: int
    split: str
    token_start: int
    token_end: int
    codon_start: int
    codon_end: int
    continues_from_previous: bool
    continues_to_next: bool

    def placed_at(self, window_lo: int, window_hi: int) -> "PackedSpan":
        """This chunk's provenance, anchored at a window position."""
        return PackedSpan(
            source_id=self.source_id,
            source_line_idx=self.source_line_idx,
            fragment_line_idx=self.fragment_line_idx,
            fragment_index=self.fragment_index,
            chunk_index=self.chunk_index,
            split=self.split,
            source_token_start=self.token_start,
            source_token_end=self.token_end,
            codon_start=self.codon_start,
            codon_end=self.codon_end,
            window_token_start=window_lo,
            window_token_end=window_hi,
            continues_from_previous=self.continues_from_previous,
            continues_to_next=self.continues_to_next,
        )


@dataclass(frozen=True)
class PackedSpan:
    """Location and provenance of a chunk inside a packed token window."""

    source_id: str
    source_line_idx: int
    fragment_line_idx: int
    fragment_index: int
    chunk_index: int
    split: str
    source_token_start: int
    source_token_end: int
    codon_start: int
    codon_end: int
    window_token_start: int
    window_token_end: int
    continues_from_previous: bool
    continues_to_next: bool

    @property
    def transition_count(self) -> int:
        return self.window_token_end - self.window_token_start - 1


@dataclass(frozen=True)
class PackedWindow:
    """A token window and the source spans placed within it."""

    tokens: tuple[int, ...]
    spans: tuple[PackedSpan, ...]


def _chunk_boundaries(n_tokens: int, capacity: int) -> list[tuple[int, int]]:
    """[start, end) windows over the token list, overlapping by one token."""
    cuts: list[tuple[int, int]] = []
    lo = 0
    while lo < n_tokens - 1:
        hi = min(lo + capacity, n_tokens)
        cuts.append((lo, hi))
        lo = hi - 1
    return cuts


def chunk_record(record: Mapping[str, Any], block_size: int) -> list[TokenChunk]:
    """Chunk one fragment with complete, exactly-once transition coverage.

    ``block_size`` counts next-token transitions, so each chunk holds at
    most ``block_size + 1`` tokens and consecutive chunks share exactly one
    boundary token. Token index t maps to codon t-1 (token 0 is <BOS_CDS>).
    """
    if block_size < 1:
        raise ValueError("block_size must be at least 1")
    tokens = tuple(int(t) for t in record["tokens"])
    if len(tokens) < 2:
        return []
    codon_base = int(record["fragment_codon_start"])
    n_codons = int(record["fragment_codon_end"]) - codon_base
    return [
        TokenChunk(
            tokens=tokens[lo:hi],
            source_id=str(record["source_id"]),
            source_line_idx=int(record["source_line_idx"]),
            fragment_line_idx=int(record["fragment_line_idx"]),
            fragment_index=int(record["fragment_index"]),
            chunk_index=idx,
            split=str(record["split"]),
            token_start=lo,
            token_end=hi,
            codon_start=codon_base + max(0, lo - 1),
            codon_end=codon_base + min(n_codons, hi - 1),
            continues_from_previous=lo > 0,
            continues_to_next=hi < len(tokens),
        )
        for idx, (lo, hi) in enumerate(_chunk_boundaries(len(tokens), block_size + 1))
    ]


class _WindowBuilder:
    """Accumulates chunks into one window; emits on flush."""

    def __init__(self, capacity: int, sep_id: int):
        self.capacity = capacity
        self.sep_id = sep_id
        self.tokens: list[int] = []
        self.spans: list[PackedSpan] = []
        self.done: list[PackedWindow] = []

    def flush(self) -> None:
        # a window with <2 tokens has no transition — drop it
        if len(self.tokens) > 1:
            self.done.append(
                PackedWindow(tokens=tuple(self.tokens), spans=tuple(self.spans))
            )
        self.tokens, self.spans = [], []

    def add(self, chunk: TokenChunk) -> None:
        # Overlapping chunks may never share a window with anything else:
        # the one-token overlap would duplicate a transition across <SEP>.
        if chunk.continues_from_previous and self.tokens:
            self.flush()
        sep_cost = 1 if self.tokens else 0
        if len(self.tokens) + sep_cost + len(chunk.tokens) > self.capacity:
            self.flush()
            sep_cost = 0
        if sep_cost:
            self.tokens.append(self.sep_id)
        lo = len(self.tokens)
        self.tokens.extend(chunk.tokens)
        self.spans.append(chunk.placed_at(lo, len(self.tokens)))
        if chunk.continues_to_next or len(self.tokens) == self.capacity:
            self.flush()


def pack_chunks(
    chunks: Iterable[TokenChunk],
    *,
    block_size: int,
    mode: str,
    sep_id: int,
) -> list[PackedWindow]:
    """Pack chunks without losing or duplicating any source transition.

    ``binpack`` is the TPU-native extension of ``multi``: whole-fragment
    chunks are placed first-fit-decreasing instead of in arrival order,
    typically cutting the padding fraction several-fold (padding is dead
    FLOPs — every window trains at block_size cost regardless of fill).
    Chunks that continue across windows keep the sequential builder's
    placement semantics; the exactly-once transition contract is
    preserved either way (span provenance is per-chunk, so placement
    order is free — ``tests/test_packing.py`` audits both modes).
    Deterministic: ties break on source identity, not input order."""
    if mode not in {"single", "dynamic", "multi", "binpack"}:
        raise ValueError(f"Unsupported pack mode: {mode!r}")
    capacity = block_size + 1
    todo = list(chunks)
    oversized = [c for c in todo if len(c.tokens) > capacity]
    if oversized:
        raise ValueError("Chunk exceeds block_size + 1 token capacity")

    if mode in {"single", "dynamic"}:
        return [
            PackedWindow(tokens=c.tokens, spans=(c.placed_at(0, len(c.tokens)),))
            for c in todo
        ]

    if mode == "binpack":
        # full-capacity chunks (they continue to the next window) can never
        # share: emit them directly. Tail chunks of a chain must be FIRST
        # in their window (the one-token overlap may not follow anything),
        # so they seed bins that whole fragments then fill. Whole
        # fragments place first-fit-decreasing.
        out: list[PackedWindow] = []
        bins: list[_WindowBuilder] = []
        full = []
        seeds = []
        whole = []
        for c in todo:
            if c.continues_to_next:
                full.append(c)
            elif c.continues_from_previous:
                seeds.append(c)
            else:
                whole.append(c)
        ident = lambda c: (c.source_id, c.fragment_line_idx, c.chunk_index)
        for c in sorted(full, key=ident):
            b = _WindowBuilder(capacity, sep_id)
            b.add(c)
            b.flush()
            out.extend(b.done)
        for c in sorted(seeds, key=ident):
            b = _WindowBuilder(capacity, sep_id)
            b.add(c)
            bins.append(b)
        # best-fit decreasing over a bisect-sorted (room, bin) list:
        # O(n log n) placement (a linear first-fit scan is quadratic once
        # most bins are nearly full — hours on ~10⁶-chunk corpora). "room"
        # is the largest chunk a bin can still accept, SEP included.
        import bisect

        room_of = lambda b: capacity - len(b.tokens) - (1 if b.tokens else 0)
        by_room = sorted(
            ((room_of(b), i) for i, b in enumerate(bins)))
        order = sorted(whole, key=lambda c: (-len(c.tokens),) + ident(c))
        for c in order:
            need = len(c.tokens)
            j = bisect.bisect_left(by_room, (need, -1))
            if j < len(by_room):
                _, i = by_room.pop(j)  # tightest sufficient bin (best fit)
                bins[i].add(c)
            else:
                bins.append(_WindowBuilder(capacity, sep_id))
                i = len(bins) - 1
                bins[i].add(c)
            bisect.insort(by_room, (room_of(bins[i]), i))
        for b in bins:
            b.flush()
            out.extend(b.done)
        return out

    builder = _WindowBuilder(capacity, sep_id)
    for chunk in todo:
        builder.add(chunk)
    builder.flush()
    return builder.done


def packing_metadata_rows(split: str, windows: Iterable[PackedWindow]) -> list[dict[str, Any]]:
    """Portable tabular provenance rows (schema: PACKING_METADATA_FIELDS)."""
    table: list[dict[str, Any]] = []
    for w_idx, window in enumerate(windows):
        for span in window.spans:
            row = {
                "split": split,
                "window_index": w_idx,
                "window_token_count": len(window.tokens),
                "starts_fragment": int(span.source_token_start == 0),
                "ends_fragment": int(not span.continues_to_next),
            }
            for field in (
                "window_token_start", "window_token_end", "source_id",
                "source_line_idx", "fragment_line_idx", "fragment_index",
                "chunk_index", "source_token_start", "source_token_end",
                "codon_start", "codon_end",
            ):
                row[field] = getattr(span, field)
            for field in ("continues_from_previous", "continues_to_next"):
                row[field] = int(getattr(span, field))
            table.append({k: row[k] for k in PACKING_METADATA_FIELDS})
    return table


def _window_provenance(window: PackedWindow) -> np.ndarray:
    """(3, n) provenance for one window: segment / source-position / chunk."""
    prov = np.full((3, len(window.tokens)), -1, dtype=np.int32)
    for span in window.spans:
        sl = slice(span.window_token_start, span.window_token_end)
        prov[0, sl] = span.fragment_line_idx
        prov[1, sl] = np.arange(
            span.source_token_start, span.source_token_end, dtype=np.int32
        )
        prov[2, sl] = span.chunk_index
    return prov


def packed_arrays(
    windows: Iterable[PackedWindow], *, block_size: int, mode: str
) -> dict[str, np.ndarray]:
    """Packed windows → loader-compatible arrays with aligned provenance."""
    window_list = list(windows)
    prov = [_window_provenance(w) for w in window_list]

    if mode == "dynamic":
        empty = np.zeros((0,), dtype=np.int32)
        return {
            "X": np.concatenate(
                [np.asarray(w.tokens, dtype=np.int32) for w in window_list]
            ) if window_list else empty,
            "lengths": np.asarray([len(w.tokens) for w in window_list], dtype=np.int32),
            "segment_ids": np.concatenate([p[0] for p in prov]) if prov else empty,
            "source_positions": np.concatenate([p[1] for p in prov]) if prov else empty,
            "chunk_ids": np.concatenate([p[2] for p in prov]) if prov else empty,
        }

    # fixed mode: shifted next-token pairs, right-padded to block_size
    shape = (len(window_list), block_size)
    out = {
        "X": np.zeros(shape, dtype=np.int32),
        "Y": np.zeros(shape, dtype=np.int32),
        "segment_ids": np.full(shape, -1, dtype=np.int32),
        "source_positions": np.full(shape, -1, dtype=np.int32),
        "chunk_ids": np.full(shape, -1, dtype=np.int32),
    }
    for i, window in enumerate(window_list):
        ids = np.asarray(window.tokens, dtype=np.int32)
        t = ids.size - 1  # transitions in this window
        out["X"][i, :t] = ids[:-1]
        out["Y"][i, :t] = ids[1:]
        out["segment_ids"][i, :t] = prov[i][0, :-1]
        out["source_positions"][i, :t] = prov[i][1, :-1]
        out["chunk_ids"][i, :t] = prov[i][2, :-1]
    return out


__all__ = [
    "PACKING_METADATA_FIELDS",
    "PackedSpan",
    "PackedWindow",
    "TokenChunk",
    "chunk_record",
    "pack_chunks",
    "packed_arrays",
    "packing_metadata_rows",
]
