"""Tokenizers: the codon vocabulary the serving path needs."""
