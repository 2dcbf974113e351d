"""Training-side utilities (this slice: the checkpoint reader only)."""
