"""Generation: KV-cached prefill, decode steps, batched sampling, and the
constrained CDS design loops."""

from genomics_lm_torch.generation.genetic_code import (  # noqa: F401
    AA_TO_CODONS,
    CODON_TABLE,
    translate_codons_to_aa,
)
