"""Plain PyTorch version of the fused NITRO matmul (port of
``repro.kernels.nitro_matmul.ref``).

Composes integer matmul → NITRO Scaling → NITRO-ReLU exactly as
``repro_torch.core`` defines them.  The CUDA kernel must match it bit for
bit; the CPU path of the dispatcher runs it.
"""

from __future__ import annotations

import torch

from repro_torch.core.activations import nitro_relu
from repro_torch.core.numerics import int_matmul
from repro_torch.core.scaling import scale_forward


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
