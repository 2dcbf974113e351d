"""Integer Kaiming initialisation (port of ``repro.core.init``).

Weights are drawn from U(-b, b), b = ⌊128·1732 / (√fan_in·1000)⌋ with an
integer √.  Draws come from an explicit ``torch.Generator``; they do not
reproduce ``jax.random``'s bits (tests carry weights across instead).
"""

from __future__ import annotations

import torch

from repro_torch.core import numerics


def kaiming_bound(fan_in: int) -> int:
    """b = ⌊128·1732 / (isqrt(fan_in)·1000)⌋, pure integer."""
    root = max(int(numerics.isqrt(fan_in)), 1)
    return max((128 * 1732) // (root * 1000), 1)


def integer_kaiming_uniform(
    generator: torch.Generator, shape: tuple[int, ...], fan_in: int,
    *, device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Discrete uniform U(-b, b) int32 weights (inclusive bounds).

    Drawn on the generator's device (the CPU for a default generator),
    then placed on ``device``.
    """
    b = kaiming_bound(fan_in)
    w = torch.randint(
        -b, b + 1, shape, generator=generator, dtype=numerics.INT_DTYPE,
        device=generator.device,
    )
    return w.to(device)
