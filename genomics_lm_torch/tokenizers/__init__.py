"""Tokenizers: the codon (68 tokens), hybrid (74) and protein (28)
vocabularies, and the k-mer splitter (``kmer_tokenize``, exported as in
``genomics_lm_tpu/tokenizers/__init__.py``)."""

from genomics_lm_torch.tokenizers.kmer import kmer_tokenize  # noqa: F401
