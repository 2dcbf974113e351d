"""Integer-only NITRO-D building blocks (the serving subset)."""
