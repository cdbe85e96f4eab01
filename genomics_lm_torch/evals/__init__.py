"""Evals that run the model: run loading (``playground``), corpus
perplexity and context ablation (``perplexity``), in-silico mutagenesis
(``mutations``)."""
