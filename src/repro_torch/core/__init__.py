"""Integer-only NITRO-D building blocks and the LES training step."""
