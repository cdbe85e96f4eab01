"""Training: the loss step and the optimizer of one accumulation group."""
