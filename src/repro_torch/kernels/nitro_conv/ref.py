"""Plain PyTorch version of the streaming implicit-im2col conv (port of
``repro.kernels.nitro_conv.ref``, inference forward).

Runs the kernel's algorithm in plain tensor ops: a loop over output-row
bands, each forming a band-local patch block from K² overlapping row
slices and feeding one integer matmul, with the scale / ReLU / 2×2 pool
epilogue applied per band.  The full ``(N·H·W, K²·C)`` patch matrix is
never formed.  Patch layout matches ``core.layers.im2col``: segment
``(ki, kj)`` at channels ``[(ki·K + kj)·C, …)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.activations import nitro_relu
from repro_torch.core.layers import window_view_2x2
from repro_torch.core.numerics import int_matmul
from repro_torch.core.scaling import scale_forward

#: Default row-band height of the CUDA kernel (the JAX package's
#: ``DEFAULT_TILES.bh``).
DEFAULT_BH = 8
_MAX_AUTO_BH = 16    # auto band cap for the plain version


def conv_geometry(h: int, k: int, bh: int | None, *, pool: bool):
    """Shared row-band geometry: clamp ``bh``, pad H up to a band multiple.

    Returns ``(bh, h_pad, pad_lo=K//2)``.  ``bh=None`` auto-sizes the band
    to ``min(H//2, 16)``.  ``bh`` is forced even when a 2×2 pool epilogue
    is fused so every band pools on its own; rows past ``H`` only produce
    output rows that are dropped.
    """
    if k % 2 == 0:
        raise ValueError(f"streaming conv requires an odd kernel, got K={k}")
    if bh is None:
        bh = min(h // 2, _MAX_AUTO_BH)
    bh = max(min(bh, h), 1)
    if pool and bh % 2:
        bh += 1
    h_pad = -(-h // bh) * bh
    return bh, h_pad, k // 2


def _band_patches(band: torch.Tensor, k: int, w_out: int) -> torch.Tensor:
    """(N, bh+2p, W+2p, C) row band → (N·bh·W, K²·C) patch block."""
    n, c = band.shape[0], band.shape[-1]
    bh = band.shape[1] - (k - 1)
    shifts = [
        band[:, ki:ki + bh, kj:kj + w_out, :]
        for ki in range(k) for kj in range(k)
    ]
    return torch.stack(shifts, dim=3).reshape(n * bh * w_out, k * k * c)


def stream_conv_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    pool: bool = False,
    out_dtype: torch.dtype = torch.int32,
    bh: int | None = None,
    operand_dtype: str = "int32",
) -> torch.Tensor:
    """Streaming fused conv: scale(+relu)(+2×2 maxpool), activation only.

    (N,H,W,C) int × (K,K,C,F) int → (N,H,W,F), or (N,H//2,W//2,F) with
    ``pool=True``.  Products are lifted to int32 whatever
    ``operand_dtype`` says (``'int8'`` only checks the operand dtypes).
    """
    if operand_dtype == "int8" and not (
        x.dtype == torch.int8 and w.dtype == torch.int8
    ):
        raise ValueError(
            f"operand_dtype='int8' requires int8 operands, got "
            f"{x.dtype}/{w.dtype}"
        )
    n, h, w_sp, c = x.shape
    k, f = w.shape[0], w.shape[-1]
    bh, h_pad, p = conv_geometry(h, k, bh, pool=pool)
    xp = F.pad(x, (0, 0, p, p, p, p + h_pad - h))
    w_flat = w.reshape(k * k * c, f)
    outs = []
    for t in range(h_pad // bh):
        band = xp[:, t * bh:t * bh + bh + 2 * p]
        z = int_matmul(_band_patches(band, k, w_sp), w_flat)
        a = scale_forward(z.reshape(n, bh, w_sp, f), sf)
        if apply_relu:
            a = nitro_relu(a, alpha_inv)
        if pool:
            a = window_view_2x2(a).amax(dim=3)
        outs.append(a.to(out_dtype))
    out = torch.cat(outs, dim=1)
    return out[:, : h // 2] if pool else out[:, :h]
