"""IntegerSGD with integer weight decay (port of ``repro.core.optimizer``,
paper §3.3, Algorithm 1).  Entirely in ℤ::

    δ_t ← ⌊ ∇f_t(W_{t-1}) / γ_inv ⌋
    if η_inv ≠ 0:  δ_t ← δ_t + ⌊ W_{t-1} / η_inv ⌋
    W_t ← W_{t-1} − δ_t

The decay term is a *floor* division, so it is asymmetric for small
weights: ``0 ≤ w < η_inv`` gives ⌊w/η_inv⌋ = 0 (untouched), while
``−η_inv ≤ w < 0`` gives −1, a +1 nudge per step until the weight
reaches 0.  That is Algorithm 1's floor arithmetic, kept as it is.

NITRO Amplification Factor: AF = 2⁶·G, and the forward layers update with
γ_inv^fw = γ_inv^lr × AF (the JAX package's reading of the paper's
``γ_inv^lr / AF``, which floor-divides to zero for its own settings).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import numerics
from repro_torch.core.numerics import floor_div


def amplification_factor(num_classes: int) -> int:
    """AF = 2⁶ × G (paper §3.3)."""
    return (2 ** 6) * int(num_classes)


class IntegerSGDState(NamedTuple):
    """Optimiser scalars as int32 0-d tensors, so the ÷3-on-plateau
    schedule is an integer tensor update."""

    gamma_inv: torch.Tensor  # inverse learning rate
    eta_inv: torch.Tensor    # inverse composite decay rate (0 = off)


def init_state(gamma_inv: int, eta_inv: int = 0, *, device="cpu") -> IntegerSGDState:
    return IntegerSGDState(
        gamma_inv=torch.tensor(gamma_inv, dtype=numerics.INT_DTYPE, device=device),
        eta_inv=torch.tensor(eta_inv, dtype=numerics.INT_DTYPE, device=device),
    )


def apply_update(w: torch.Tensor, grad: torch.Tensor,
                 state: IntegerSGDState) -> torch.Tensor:
    """One Algorithm-1 step for a single weight tensor (int32, wraps)."""
    numerics.assert_int(w, "weights")
    numerics.assert_int(grad, "gradient")
    delta = floor_div(grad, state.gamma_inv)
    decay = torch.where(
        state.eta_inv != 0,
        floor_div(w, state.eta_inv.clamp(min=1)),
        torch.zeros_like(w),
    )
    return w - (delta + decay)


def apply_tree(params: dict, grads: dict, state: IntegerSGDState) -> dict:
    """IntegerSGD over a ``{"w": tensor}`` parameter dict."""
    return {k: apply_update(w, grads[k], state) for k, w in params.items()}


def step_lr_schedule(state: IntegerSGDState, plateau) -> IntegerSGDState:
    """γ_inv ← γ_inv · 3 when the accuracy plateaus."""
    plateau = torch.as_tensor(plateau, device=state.gamma_inv.device)
    new_gamma = torch.where(plateau, state.gamma_inv * 3, state.gamma_inv)
    return state._replace(gamma_inv=new_gamma)
