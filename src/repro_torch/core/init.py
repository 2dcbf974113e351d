"""Integer Kaiming initialisation (port of ``repro.core.init``).

Weights are drawn from U(-b, b), b = ⌊128·1732 / (√fan_in·1000)⌋ with an
integer √.  Draws come from a threefry key (``core.prng``), so a key
gives exactly the weights ``jax.random.randint`` gives the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.core import numerics, prng


def kaiming_bound(fan_in: int) -> int:
    """b = ⌊128·1732 / (isqrt(fan_in)·1000)⌋, pure integer."""
    root = max(int(numerics.isqrt(fan_in)), 1)
    return max((128 * 1732) // (root * 1000), 1)


def integer_kaiming_uniform(
    key: torch.Tensor, shape: tuple[int, ...], fan_in: int,
    *, device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Discrete uniform U(-b, b) int32 weights (inclusive bounds), drawn
    on ``device``."""
    b = kaiming_bound(fan_in)
    return prng.randint(key, shape, -b, b + 1, device=device)
