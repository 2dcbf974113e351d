"""Training-side utilities: checkpoints in the JAX package's format, the
LM trainer (``trainer``) and its AdamW (``optimizer``)."""
