"""Integer layers, forward half (port of ``repro.core.layers``).

Layout is NHWC / (batch, features); weights are (fan_in, fan_out) for
linear and (K, K, C_in, C_out) for conv, as in the JAX package.  Conv2D
is im2col + integer matmul, with the patch channel order
``(ki·K + kj)·C + c`` that ``w.reshape(K²C, F)`` expects.

Only the inference forward is ported here; the caches and hand-derived
backward passes come with training.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import numerics
from repro_torch.core.init import integer_kaiming_uniform
from repro_torch.core.numerics import int_matmul


def linear_init(generator: torch.Generator, fan_in: int, fan_out: int,
                *, device="cpu") -> dict:
    """IntegerLinear params — no bias (Appendix B.1)."""
    return {"w": integer_kaiming_uniform(
        generator, (fan_in, fan_out), fan_in, device=device)}


def linear_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """z = x @ W with int32 accumulation."""
    numerics.assert_int(x, "linear input")
    return int_matmul(x, params["w"])


def conv_init(generator: torch.Generator, in_channels: int, out_channels: int,
              kernel_size: int = 3, *, device="cpu") -> dict:
    fan_in = kernel_size * kernel_size * in_channels
    shape = (kernel_size, kernel_size, in_channels, out_channels)
    return {"w": integer_kaiming_uniform(generator, shape, fan_in, device=device)}


def im2col(x: torch.Tensor, kernel_size: int, padding: int) -> torch.Tensor:
    """Extract K×K patches: (N,H,W,C) → (N,H,W,K·K·C), zero 'same' halo."""
    n, h, w, c = x.shape
    k = kernel_size
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    shifts = [xp[:, i:i + h, j:j + w, :] for i in range(k) for j in range(k)]
    return torch.stack(shifts, dim=3).reshape(n, h, w, k * k * c)


def conv_im2col_operands(
    w: torch.Tensor, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,H,W,C) input + (K,K,C,F) weight → (N·H·W, K²C) patches and the
    (K²C, F) flattened weight."""
    k = w.shape[0]
    n, h, ww, c = x.shape
    patches = im2col(x, k, k // 2).reshape(n * h * ww, k * k * c)
    return patches, w.reshape(-1, w.shape[-1])


def conv_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """z[n,h,w,f] = Σ_{i,j,c} x[n,h+i-p,w+j-p,c] · W[i,j,c,f] (int32)."""
    numerics.assert_int(x, "conv input")
    n, h, ww, _ = x.shape
    patches, w_flat = conv_im2col_operands(params["w"], x)
    return int_matmul(patches, w_flat).reshape(n, h, ww, w_flat.shape[-1])


def window_view_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) → (N,H//2,W//2,4,C), cropping odd trailing rows/cols."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : h2 * 2, : w2 * 2, :]
    x = x.reshape(n, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h2, w2, 4, c)


def maxpool_forward(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 integer max-pool (floor pooling for odd sizes)."""
    numerics.assert_int(x, "maxpool input")
    return window_view_2x2(x).amax(dim=3)


def avgpool_grid(h: int, w: int, c: int, target: int) -> tuple[int, int]:
    """``avgpool_to``'s grid: (s, window) with s the largest grid whose
    s²·C ≤ ``target`` features, clamped to the spatial size."""
    s = max(math.isqrt(max(target // c, 1)), 1)
    s = min(s, h, w)
    return s, h // s


def flatten_forward(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)
