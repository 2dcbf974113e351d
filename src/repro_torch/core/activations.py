"""NITRO-ReLU activation and its integer derivative (port of
``repro.core.activations``).

    x < -127      : ⌊-127/α_inv⌋ - μ_int8
    -127 ≤ x < 0  : ⌊x/α_inv⌋    - μ_int8
    0 ≤ x ≤ 127   : x            - μ_int8
    x > 127       : 127          - μ_int8
"""

from __future__ import annotations

import torch

from repro_torch.core import numerics
from repro_torch.core.numerics import ACT_MAX, ACT_MIN

DEFAULT_ALPHA_INV = 10  # α = 0.1 → α_inv = ⌊1/α⌋ = 10


def segment_means(alpha_inv: int) -> tuple[int, int, int, int]:
    """μ^i_int8 for segments i = 0..3 (paper §3.2), pure Python ints."""
    m0 = -127 // alpha_inv          # x < -127
    m1 = -127 // (2 * alpha_inv)    # -127 ≤ x ≤ 0
    m2 = 63                         # 0 < x ≤ 127
    m3 = 127                        # x > 127
    return m0, m1, m2, m3


def mu_int8(alpha_inv: int = DEFAULT_ALPHA_INV) -> int:
    """μ_int8 = integer mean of the four segment means."""
    return sum(segment_means(alpha_inv)) // 4


def relu_fits_int8(alpha_inv: int = DEFAULT_ALPHA_INV) -> bool:
    """NITRO-ReLU output range [⌊-127/α_inv⌋-μ, 127-μ] within int8?

    True for every α_inv ≥ 2; α_inv = 1 gives μ = -1 and a top of 128.
    """
    mu = mu_int8(alpha_inv)
    lo = (-127) // alpha_inv - mu
    hi = 127 - mu
    return -128 <= lo and hi <= 127


def nitro_relu(z_star: torch.Tensor, alpha_inv: int = DEFAULT_ALPHA_INV) -> torch.Tensor:
    """Forward NITRO-ReLU: integer in, integer out in [-127-μ, 127-μ]."""
    numerics.assert_int(z_star, "nitro_relu input")
    neg = numerics.floor_div(z_star.clamp(min=ACT_MIN), alpha_inv)
    pos = z_star.clamp(max=ACT_MAX)
    return torch.where(z_star < 0, neg, pos) - mu_int8(alpha_inv)


def nitro_relu_backward(
    z_star: torch.Tensor, grad_out: torch.Tensor,
    alpha_inv: int = DEFAULT_ALPHA_INV,
) -> torch.Tensor:
    """Integer derivative of NITRO-ReLU w.r.t. its input.

    Segment derivatives: 0 (saturated) / 1/α_inv (leaky, a floor
    division) / 1 (identity) / 0 (saturated).
    """
    numerics.assert_int(z_star, "nitro_relu_backward z")
    numerics.assert_int(grad_out, "nitro_relu_backward grad")
    leaky = numerics.floor_div(grad_out, alpha_inv)
    grad_in = torch.where(z_star < 0, leaky, grad_out)
    saturated = (z_star < ACT_MIN) | (z_star > ACT_MAX)
    return torch.where(saturated, torch.zeros_like(grad_in), grad_in)
