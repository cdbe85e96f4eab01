"""Training: the accumulation-group step and its optimizer, checkpoints,
the run lifecycle, and the trainer (``loop.run_training``) with its CLI."""
