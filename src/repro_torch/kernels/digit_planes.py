"""Signed base-256 digits of int32 values, as the int8 tensor-core kernels
compute with them (``csrc_common/digit_gemm.cuh``): every int32 v is four
digits d0..d3 in [−128, 127] with v ≡ Σ_i 2^(8i)·d_i (mod 2^32), and a
product of two int32 sums is the sum of the digit products with
i + j ≤ 3, each exact in int8 × int8 → int32.  Shared by the plain models
of the conv and matmul kernels (``nitro_conv/ref.py``,
``nitro_matmul/ref.py``).
"""

from __future__ import annotations

import torch

#: Digits of an int32 and the pixel tile the planes are padded to.
N_DIGITS = 4
PIXEL_TILE = 64


def s8_digits(v: torch.Tensor) -> torch.Tensor:
    """(4, *v.shape) int8: the balanced base-256 digits d0..d3 of int32 v,
    each in [−128, 127], with v ≡ Σ_i 2^(8i)·d_i (mod 2^32).

    d0 = ((v + 128) mod 256) − 128, then v ← (v − d0) / 256, and so on,
    worked mod 2^32; the top digit keeps what is left and wraps mod 256.
    """
    u = v.to(torch.int64) & 0xFFFFFFFF
    out = []
    for _ in range(N_DIGITS - 1):
        d = ((u + 128) & 255) - 128
        out.append(d)
        u = ((u - d) & 0xFFFFFFFF) >> 8
    out.append(((u + 128) & 255) - 128)
    return torch.stack(out).to(torch.int8)


def digits_needed(v: torch.Tensor) -> int:
    """What the kernel's δ pre-pass records: 1 + the index of the highest
    nonzero digit of any element (1 when every element is 0)."""
    nonzero = s8_digits(v).reshape(N_DIGITS, -1).ne(0).any(dim=1)
    return 1 + max((i for i in range(N_DIGITS) if bool(nonzero[i])), default=0)


def x_fits_s8(x: torch.Tensor) -> bool:
    """What the kernel's x pre-pass records: every x in [−128, 127], so x
    is its own digit 0 and needs no other plane."""
    return x.numel() == 0 or bool(((x >= -128) & (x <= 127)).all())


def padded_planes(rows: torch.Tensor, digits: int) -> torch.Tensor:
    """(R, P) int32 → (digits, R, Pp) int8 digit planes, P zero-padded to
    a multiple of the pixel tile."""
    r, p = rows.shape
    pp = -(-p // PIXEL_TILE) * PIXEL_TILE
    planes = torch.zeros((digits, r, pp), dtype=torch.int8, device=rows.device)
    planes[:, :, :p] = s8_digits(rows)[:digits]
    return planes
