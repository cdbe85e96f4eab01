"""GenBank flat-file parsing and CDS/genomic-window extraction (the port's
own copy of ``genomics_lm_tpu/data/genbank.py``, standard library only).

The GBFF format is parsed directly (no BioPython): LOCUS records split on
``//``, FEATURES with join/order/complement/partial location expressions,
qualifiers wrapped over several lines (``/translation`` joins without
spaces), locations continued on the next line, and the ORIGIN sequence
block. Only the fields the pipeline consumes are modeled. The four
extractors give the rows of the reference's ``extract_cds_from_genbank.py``
(CDS DNA + metadata, IUPAC reverse complement), ``extract_genomic_tape.py``
(sliding chromosomal windows), ``extract_anchored_operons.py``
(gene-boundary windows) and ``extract_hybrid_from_genbank.py`` (CDS
intervals for the hybrid tokenizer). Every field equals the JAX package's
(``tests/test_torch_genbank.py``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

_COMPLEMENT = str.maketrans(
    "ACGTRYSWKMBDHVNacgtryswkmbdhvn", "TGCAYRSWMKVHDBNtgcayrswmkvhdbn"
)


def reverse_complement(seq: str) -> str:
    """IUPAC-aware reverse complement."""
    return seq.translate(_COMPLEMENT)[::-1]


@dataclass
class Feature:
    type: str
    location: str
    qualifiers: dict[str, str] = field(default_factory=dict)
    # parsed location
    intervals: list[tuple[int, int]] = field(default_factory=list)  # 0-based half-open
    strand: str = "+"
    partial: bool = False

    def extract(self, sequence: str) -> str:
        """Oriented feature sequence (joined exons, minus-strand revcomp)."""
        parts = [sequence[a:b] for a, b in self.intervals]
        seq = "".join(parts)
        return reverse_complement(seq) if self.strand == "-" else seq


@dataclass
class GenBankRecord:
    name: str
    definition: str
    accession: str
    organism: str
    sequence: str
    features: list[Feature]

    @property
    def cds_features(self) -> list[Feature]:
        return [f for f in self.features if f.type == "CDS"]


_LOC_RANGE = re.compile(r"[<>]?(\d+)\.\.[<>]?(\d+)")
_LOC_SINGLE = re.compile(r"^[<>]?(\d+)$")


def _parse_location(location: str) -> tuple[list[tuple[int, int]], str, bool]:
    """GenBank location expression → (intervals 0-based half-open, strand, partial)."""
    loc = location.replace(" ", "")
    strand = "+"
    partial = "<" in loc or ">" in loc
    while True:
        if loc.startswith("complement(") and loc.endswith(")"):
            strand = "-" if strand == "+" else "+"
            loc = loc[len("complement(") : -1]
            continue
        if loc.startswith(("join(", "order(")) and loc.endswith(")"):
            loc = loc[loc.index("(") + 1 : -1]
            continue
        break
    intervals: list[tuple[int, int]] = []
    for part in loc.split(","):
        m = _LOC_RANGE.search(part)
        if m:
            start, end = int(m.group(1)), int(m.group(2))
            intervals.append((start - 1, end))
            continue
        m = _LOC_SINGLE.match(part)
        if m:
            pos = int(m.group(1))
            intervals.append((pos - 1, pos))
    return intervals, strand, partial


def parse_genbank(path: str | Path) -> Iterator[GenBankRecord]:
    """Stream records from a GenBank flat file (.gb / .gbff)."""
    text = Path(path).read_text()
    for chunk in re.split(r"^//\s*$", text, flags=re.MULTILINE):
        if "LOCUS" not in chunk:
            continue
        yield _parse_record(chunk)


def _parse_record(chunk: str) -> GenBankRecord:
    lines = chunk.splitlines()
    name = definition = accession = organism = ""
    features: list[Feature] = []
    seq_parts: list[str] = []
    section = None
    current: Feature | None = None
    pending_qualifier: str | None = None

    for line in lines:
        if line.startswith("LOCUS"):
            parts = line.split()
            name = parts[1] if len(parts) > 1 else ""
            section = "header"
        elif line.startswith("DEFINITION"):
            definition = line[len("DEFINITION") :].strip()
            section = "definition"
        elif line.startswith("ACCESSION"):
            accession = line[len("ACCESSION") :].strip().split()[0] if line[len("ACCESSION"):].strip() else ""
            section = "header"
        elif line.startswith("  ORGANISM"):
            organism = line[len("  ORGANISM") :].strip()
            section = "header"
        elif line.startswith("FEATURES"):
            section = "features"
        elif line.startswith("ORIGIN"):
            section = "origin"
        elif section == "definition" and line.startswith("            "):
            definition += " " + line.strip()
        elif section == "features":
            if len(line) > 5 and line[5] != " " and line[:5].strip() == "":
                # new feature: "     CDS             complement(12..78)"
                ftype = line[5:21].strip()
                location = line[21:].strip()
                current = Feature(type=ftype, location=location)
                features.append(current)
                pending_qualifier = None
            elif current is not None and line.strip().startswith("/"):
                body = line.strip()[1:]
                if "=" in body:
                    key, value = body.split("=", 1)
                    value = value.strip().strip('"')
                    current.qualifiers[key] = value
                    pending_qualifier = key if not body.rstrip().endswith('"') or body.count('"') == 1 else None
                else:
                    current.qualifiers[body] = "true"
                    pending_qualifier = None
            elif current is not None and line.startswith(" " * 21):
                stripped = line.strip()
                if pending_qualifier is not None:
                    joined = current.qualifiers[pending_qualifier] + (
                        "" if pending_qualifier == "translation" else " "
                    ) + stripped.strip('"')
                    current.qualifiers[pending_qualifier] = joined
                    if stripped.endswith('"'):
                        pending_qualifier = None
                else:
                    current.location += stripped
        elif section == "origin":
            seq_parts.append(re.sub(r"[\d\s]", "", line))

    sequence = "".join(seq_parts).upper()
    for feature in features:
        feature.intervals, feature.strand, feature.partial = _parse_location(
            feature.location
        )
    return GenBankRecord(
        name=name, definition=definition, accession=accession,
        organism=organism, sequence=sequence, features=features,
    )


# --- extractors --------------------------------------------------------------


def extract_cds_records(path: str | Path) -> list[dict]:
    """CDS DNA + metadata rows (parity: extract_cds_from_genbank.py)."""
    rows = []
    for record in parse_genbank(path):
        for index, cds in enumerate(record.cds_features):
            if not cds.intervals:
                continue
            dna = cds.extract(record.sequence)
            if len(dna) < 3:
                continue
            rows.append({
                "source_id": f"{record.accession or record.name}:CDS:{index}",
                "record": record.accession or record.name,
                "organism": record.organism,
                "locus_tag": cds.qualifiers.get("locus_tag", ""),
                "gene": cds.qualifiers.get("gene", ""),
                "product": cds.qualifiers.get("product", ""),
                "protein_id": cds.qualifiers.get("protein_id", ""),
                "strand": cds.strand,
                "start": cds.intervals[0][0],
                "end": cds.intervals[-1][1],
                "partial": cds.partial,
                "sequence": dna,
            })
    return rows


def extract_genomic_tape(
    path: str | Path, *, window: int = 1536, stride: int = 768
) -> list[dict]:
    """Sliding chromosomal windows for operon context
    (parity: extract_genomic_tape.py — 1536 bp windows, 768 bp stride)."""
    rows = []
    for record in parse_genbank(path):
        seq = record.sequence
        for start in range(0, max(1, len(seq) - window + 1), stride):
            rows.append({
                "source_id": f"{record.accession or record.name}:tape:{start}",
                "record": record.accession or record.name,
                "start": start,
                "end": min(start + window, len(seq)),
                "sequence": seq[start : start + window],
            })
    return rows


def extract_anchored_operons(
    path: str | Path, *, upstream: int = 256, downstream: int = 256
) -> list[dict]:
    """Gene-boundary-anchored windows (parity: extract_anchored_operons.py)."""
    rows = []
    for record in parse_genbank(path):
        seq = record.sequence
        for index, cds in enumerate(record.cds_features):
            if not cds.intervals:
                continue
            anchor = cds.intervals[0][0] if cds.strand == "+" else cds.intervals[-1][1]
            start = max(0, anchor - upstream)
            end = min(len(seq), anchor + downstream)
            window = seq[start:end]
            if cds.strand == "-":
                window = reverse_complement(window)
            rows.append({
                "source_id": f"{record.accession or record.name}:operon:{index}",
                "record": record.accession or record.name,
                "locus_tag": cds.qualifiers.get("locus_tag", ""),
                "strand": cds.strand,
                "anchor": anchor,
                "sequence": window,
            })
    return rows


def extract_hybrid_records(path: str | Path) -> list[dict]:
    """Per-record sequence + CDS (start, end, strand) intervals for the
    hybrid tokenizer (parity: extract_hybrid_from_genbank.py)."""
    rows = []
    for record in parse_genbank(path):
        intervals = [
            (cds.intervals[0][0], cds.intervals[-1][1], cds.strand)
            for cds in record.cds_features
            if cds.intervals
        ]
        intervals.sort(key=lambda iv: iv[0])
        # the hybrid tokenizer rejects overlapping CDS; drop later overlaps
        filtered: list[tuple[int, int, str]] = []
        for iv in intervals:
            if filtered and iv[0] < filtered[-1][1]:
                continue
            filtered.append(iv)
        rows.append({
            "source_id": record.accession or record.name,
            "organism": record.organism,
            "sequence": record.sequence,
            "cds_intervals": filtered,
            "dropped_overlapping": len(intervals) - len(filtered),
        })
    return rows


__all__ = [
    "Feature",
    "GenBankRecord",
    "extract_anchored_operons",
    "extract_cds_records",
    "extract_genomic_tape",
    "extract_hybrid_records",
    "parse_genbank",
    "reverse_complement",
]
