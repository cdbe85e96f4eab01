"""Standard genetic code tables and codon→AA translation: the port's own copy
of ``genomics_lm_tpu/generation/genetic_code.py`` (stop codons map to '_')."""

from __future__ import annotations

from collections import defaultdict

CODON_TABLE = {
    "ATA": "I", "ATC": "I", "ATT": "I", "ATG": "M",
    "ACA": "T", "ACC": "T", "ACG": "T", "ACT": "T",
    "AAC": "N", "AAT": "N", "AAG": "K", "AAA": "K",
    "GCA": "A", "GCC": "A", "GCG": "A", "GCT": "A",
    "GAC": "D", "GAT": "D", "GAG": "E", "GAA": "E",
    "GGA": "G", "GGC": "G", "GGG": "G", "GGT": "G",
    "CTA": "L", "CTC": "L", "CTG": "L", "CTT": "L",
    "CCA": "P", "CCC": "P", "CCG": "P", "CCT": "P",
    "CAC": "H", "CAT": "H", "CAG": "Q", "CAA": "Q",
    "CGA": "R", "CGC": "R", "CGG": "R", "CGT": "R",
    "GTA": "V", "GTC": "V", "GTG": "V", "GTT": "V",
    "TCA": "S", "TCC": "S", "TCG": "S", "TCT": "S",
    "TTC": "F", "TTT": "F", "TTA": "L", "TTG": "L",
    "TAC": "Y", "TAT": "Y", "TAA": "_", "TAG": "_",
    "TGC": "C", "TGT": "C", "TGA": "_", "TGG": "W",
    "AGA": "R", "AGG": "R", "AGC": "S", "AGT": "S",
}

AA_TO_CODONS: dict[str, list[str]] = defaultdict(list)
for _codon, _aa in CODON_TABLE.items():
    AA_TO_CODONS[_aa].append(_codon)


def translate_codons_to_aa(codons: list[str], *, stop_char: str = "_") -> str:
    """Codon strings → AA string; unknown codons become 'X'."""
    return "".join(CODON_TABLE.get(c.upper(), "X") for c in codons)


__all__ = ["AA_TO_CODONS", "CODON_TABLE", "translate_codons_to_aa"]
