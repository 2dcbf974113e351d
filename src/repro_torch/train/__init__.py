"""Training-side utilities: checkpoints in the JAX package's format."""
