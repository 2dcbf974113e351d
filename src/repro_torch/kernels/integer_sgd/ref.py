"""Plain PyTorch version of the fused IntegerSGD kernel (port of
``repro.kernels.integer_sgd.ref``): delegates to the canonical
Algorithm-1 implementation, ``repro_torch.core.optimizer.apply_update``."""

from __future__ import annotations

import torch

from repro_torch.core import optimizer as opt
from repro_torch.core.numerics import INT_DTYPE


def integer_sgd_ref(w: torch.Tensor, g: torch.Tensor, gamma_inv,
                    eta_inv) -> torch.Tensor:
    """``W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋)``, no decay for η_inv = 0; the
    divisors may be ints or 0-d int32 tensors."""
    state = opt.IntegerSGDState(
        gamma_inv=torch.as_tensor(gamma_inv, dtype=INT_DTYPE, device=w.device),
        eta_inv=torch.as_tensor(eta_inv, dtype=INT_DTYPE, device=w.device),
    )
    return opt.apply_update(w, g, state)
