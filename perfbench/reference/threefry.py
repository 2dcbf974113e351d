"""Threefry-2x32 bits, a frozen copy of the draws NITRO-D's dropout makes.

The program's dropout mask is ``bits(key, shape) < threshold`` on the
threefry2x32 stream of ``jax.random`` (partitionable counters: element i
of the flattened shape is counter (i >> 32, i & 0xffffffff)).  The plain
reference draws the same bits from the same key here, without importing
the program.  A key is an int64 tensor of shape (2,) on the host holding
two uint32 words; a draw's words are int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round block cipher on counter words (x0, x1), int64 tensors
    of uint32 values; returns the two output words."""
    k0, k1 = (int(v) for v in key.tolist())
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` keys from ``key``: row i is threefry(key, counter (0, i))."""
    i = torch.arange(n, dtype=torch.int64)
    x0, x1 = threefry2x32(key, i >> 32, i & _M32)
    return torch.stack([x0, x1], dim=1)


def bits(key: torch.Tensor, shape, device) -> torch.Tensor:
    """uint32 bits (as int64) for every element of ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, i >> 32, i & _M32)
    return (x0 ^ x1).reshape(tuple(int(d) for d in shape))
