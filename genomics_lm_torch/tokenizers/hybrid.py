"""Hybrid multi-scale tokenizer: CDS → codons, UTR/intergenic → nucleotides
(the port's own copy of ``genomics_lm_tpu/tokenizers/hybrid.py``).

74-token vocabulary (parity with reference ``src/codonlm/hybrid_tokenizer.py``):
6 specials (``<PAD> <BOS_CDS> <EOS_CDS> <UNK> <UTR_START> <UTR_END>``) +
64 codons (AAA..TTT lexical) + 4 nucleotides (A C G T). Overlapping CDS
intervals are rejected. Reverse-strand CDS are reverse-complemented before
codon tokenization so models always see the coding orientation.
"""

from __future__ import annotations

PAD_TOKEN = "<PAD>"
BOS_CDS = "<BOS_CDS>"
EOS_CDS = "<EOS_CDS>"
UNK_TOKEN = "<UNK>"
UTR_START = "<UTR_START>"
UTR_END = "<UTR_END>"

_COMPLEMENT = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


class HybridTokenizer:
    """Encode genomic DNA with per-region granularity (codons vs bases)."""

    def __init__(self) -> None:
        self.special_tokens = [PAD_TOKEN, BOS_CDS, EOS_CDS, UNK_TOKEN, UTR_START, UTR_END]
        bases = ["A", "C", "G", "T"]
        self.codons = [a + b + c for a in bases for b in bases for c in bases]
        self.nucleotides = bases
        self.vocab = list(self.special_tokens) + list(self.codons) + list(self.nucleotides)
        self.stoi = {tok: i for i, tok in enumerate(self.vocab)}
        self.itos = list(self.vocab)
        self.vocab_size = len(self.vocab)

    @staticmethod
    def reverse_complement(seq: str) -> str:
        """Reverse complement, preserving case; unknown bases pass through."""
        return seq.translate(_COMPLEMENT)[::-1]

    def _segments(self, seq_len: int, cds_intervals):
        ordered = sorted(cds_intervals, key=lambda iv: iv[0])
        for prev, nxt in zip(ordered, ordered[1:]):
            if prev[1] > nxt[0]:
                raise ValueError(
                    "Overlapping CDS intervals are not supported in the standard HybridTokenizer."
                )
        segments = []
        cursor = 0
        for start, end, strand in ordered:
            if start > cursor:
                segments.append(("UTR", cursor, start, None))
            segments.append(("CDS", start, end, strand))
            cursor = end
        if cursor < seq_len:
            segments.append(("UTR", cursor, seq_len, None))
        return segments

    def encode(self, sequence: str, cds_intervals) -> list[int]:
        """Genomic DNA + (start, end, strand) CDS intervals → token ids.

        Intervals are 0-indexed half-open; strand is '+' or '-'. Parity:
        reference ``hybrid_tokenizer.py:54-121``.
        """
        if not sequence:
            return []
        unk = self.stoi[UNK_TOKEN]
        out: list[int] = []
        for seg_type, start, end, strand in self._segments(len(sequence), cds_intervals):
            seg = sequence[start:end].upper()
            if not seg:
                continue
            if seg_type == "UTR":
                out.append(self.stoi[UTR_START])
                out.extend(self.stoi.get(base, unk) for base in seg)
                out.append(self.stoi[UTR_END])
            else:
                out.append(self.stoi[BOS_CDS])
                coding = self.reverse_complement(seg) if strand == "-" else seg
                out.extend(
                    self.stoi.get(coding[i : i + 3], unk)
                    for i in range(0, len(coding) - 2, 3)
                )
                out.append(self.stoi[EOS_CDS])
        return out

    def decode(self, token_ids) -> str:
        """Ids → concatenated sequence text (mRNA orientation for CDS)."""
        parts = []
        for tid in token_ids:
            tid = int(tid)
            if tid < 0 or tid >= self.vocab_size:
                continue
            tok = self.itos[tid]
            if tok in self.special_tokens:
                continue
            parts.append(tok)
        return "".join(parts)

    def decode_genomic(self, token_ids, cds_intervals) -> str:
        """Reconstruct original-orientation genomic DNA from ids + intervals."""
        ordered = sorted(cds_intervals, key=lambda iv: iv[0])
        segments = []
        cursor = 0
        for start, end, strand in ordered:
            if start > cursor:
                segments.append(("UTR", None))
            segments.append(("CDS", strand))
            cursor = end

        idx = 0
        n = len(token_ids)
        decoded: list[str] = []

        def read_until(stop_id: int, start_id: int) -> list[str]:
            nonlocal idx
            if idx < n and token_ids[idx] == start_id:
                idx += 1
            toks = []
            while idx < n and token_ids[idx] != stop_id:
                toks.append(self.itos[token_ids[idx]])
                idx += 1
            if idx < n:
                idx += 1  # consume the stop marker
            return toks

        for seg_type, strand in segments:
            if seg_type == "UTR":
                decoded.append("".join(read_until(self.stoi[UTR_END], self.stoi[UTR_START])))
            else:
                cds = "".join(read_until(self.stoi[EOS_CDS], self.stoi[BOS_CDS]))
                decoded.append(self.reverse_complement(cds) if strand == "-" else cds)
        if idx < n and token_ids[idx] == self.stoi[UTR_START]:
            decoded.append("".join(read_until(self.stoi[UTR_END], self.stoi[UTR_START])))
        return "".join(decoded)
