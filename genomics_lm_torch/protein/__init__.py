"""Protein-critic stack (twin of ``genomics_lm_tpu/protein/``): datasets,
losses, the LM / classifier / multi-task / EBM / MLP-heads trainers, critic
scoring for generation guidance, the latent Langevin sampler, and their
CLIs (``python -m genomics_lm_torch.protein.<cli> ... [--device cpu]``).
"""
