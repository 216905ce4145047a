"""Training runtime: train state, optimizers, checkpoints, logging, trainer."""
