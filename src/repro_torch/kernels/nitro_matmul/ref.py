"""Plain PyTorch versions of the NITRO matmul kernels (port of
``repro.kernels.nitro_matmul.ref``).

Composes integer matmul → NITRO Scaling → NITRO-ReLU (forward),
NITRO-ReLU derivative → integer matmul (weight and input gradients) and
the weight gradient → IntegerSGD (weight update) exactly as
``repro_torch.core`` defines them.  The CUDA kernels must match them bit
for bit; the CPU path of the dispatchers runs them.
"""

from __future__ import annotations

import torch

from repro_torch.core.activations import nitro_relu, nitro_relu_backward
from repro_torch.core.numerics import INT_DTYPE, int_matmul
from repro_torch.core.scaling import scale_backward, scale_forward
from repro_torch.kernels.integer_sgd.ref import integer_sgd_ref


def nitro_matmul_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    out_dtype: torch.dtype = torch.int32,
    operand_dtype: str = "int32",
) -> torch.Tensor:
    """``relu(⌊(x @ w)/sf⌋) − μ`` (or the scale alone) for 2-D ``x``, ``w``.

    ``operand_dtype='int8'`` only checks that both operands are int8: the
    product is lifted to int32 either way (``int_matmul``), which is
    exactly the int8×int8→int32 accumulation.
    """
    if operand_dtype == "int8" and not (
        x.dtype == torch.int8 and w.dtype == torch.int8
    ):
        raise ValueError(
            f"operand_dtype='int8' requires int8 operands, got "
            f"{x.dtype}/{w.dtype}"
        )
    z_star = scale_forward(int_matmul(x, w), sf)
    if apply_relu:
        z_star = nitro_relu(z_star, alpha_inv)
    return z_star.to(out_dtype)


def nitro_matmul_fwd_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    out_dtype: torch.dtype = torch.int32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: ``(a, z_star)``; ``z_star`` is always int32 (the
    cache the NITRO-ReLU/STE backward reads)."""
    z_star = scale_forward(int_matmul(x, w), sf)
    return nitro_relu(z_star, alpha_inv).to(out_dtype), z_star


def masked_delta(delta: torch.Tensor, z_star: torch.Tensor,
                 alpha_inv: int) -> torch.Tensor:
    """The δ prologue the grad kernels apply on load: NITRO-ReLU
    derivative, then the scaling STE (the identity)."""
    return scale_backward(nitro_relu_backward(z_star, delta, alpha_inv))


def nitro_matmul_grad_w_ref(
    x: torch.Tensor,
    delta: torch.Tensor,
    z_star: torch.Tensor,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Weight gradient ``xᵀ @ relu_bwd(z*, δ)``: x (B,M), δ/z* (B,N) →
    (M,N) int32."""
    g = masked_delta(delta.to(INT_DTYPE), z_star, alpha_inv)
    return int_matmul(x.to(INT_DTYPE).T, g)


def nitro_matmul_grad_w_opt_ref(
    x: torch.Tensor,
    delta: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    gamma_inv,
    eta_inv,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Weight update: ``nitro_matmul_grad_w_ref`` then IntegerSGD → W′
    (M,N) int32."""
    grad_w = nitro_matmul_grad_w_ref(x, delta, z_star, alpha_inv=alpha_inv)
    return integer_sgd_ref(w, grad_w, gamma_inv, eta_inv)


def nitro_matmul_grad_x_ref(
    delta: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Input gradient ``relu_bwd(z*, δ) @ wᵀ``: δ/z* (B,N), w (M,N) in its
    natural layout → (B,M) int32."""
    g = masked_delta(delta.to(INT_DTYPE), z_star, alpha_inv)
    return int_matmul(g, w.to(INT_DTYPE).T)
