"""NITRO Scaling Layer (port of ``repro.core.scaling``).

    z*_l = ⌊ z_l / SF_l ⌋,   SF = 2⁸·M (linear),  SF = 2⁸·K²·C (conv)
"""

from __future__ import annotations

import torch

from repro_torch.core import numerics


def linear_scale_factor(fan_in: int) -> int:
    """SF for an Integer Linear layer with ``fan_in`` input features."""
    return (2 ** 8) * int(fan_in)


def conv_scale_factor(kernel_size: int, in_channels: int) -> int:
    """SF for an Integer Conv2D layer (K×K kernel, C input channels)."""
    return (2 ** 8) * int(kernel_size) ** 2 * int(in_channels)


def scale_forward(z: torch.Tensor, sf: int) -> torch.Tensor:
    """z* = ⌊z / SF⌋ — pure integer floor division."""
    numerics.assert_int(z, "pre-activations")
    return numerics.floor_div(z, sf)


def scale_backward(grad_out: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: δ^{ic} = δ^{sl} (paper §3.2)."""
    return grad_out


def pow2_split(sf: int) -> tuple[int, int]:
    """Split SF into (shift, residual) with SF = residual << shift.

    The kernels floor-divide by the power of two with an arithmetic right
    shift and by the odd residual with one explicit floor divide.
    """
    shift = 0
    while sf % 2 == 0 and sf > 1:
        sf //= 2
        shift += 1
    return shift, sf
