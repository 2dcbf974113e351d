"""Plain model of ``int_matmul``'s route W as its kernel computes it.

``wgmma_matmul`` repeats ``csrc_common/wgmma_s8.cuh``'s arithmetic on the
CPU: s32 sums over at most ``FOLD_COLS`` contraction columns (checked to
stay below 2³¹, as the tensor cores' s32 accumulators must), each folded
into an unsigned running total mod 2³².  It equals ``numerics.int_matmul``
for every int8 input; the tests hold it against the JAX package's.
"""

from __future__ import annotations

import torch

from repro_torch.core.numerics import INT_DTYPE

#: columns an s32 accumulator sums before it is folded (wgmma_s8.cuh's
#: CHUNK stages of BK bytes)
FOLD_COLS = 16384


def wgmma_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 · b (K, N) int8 → int32 mod 2³², folded every
    ``FOLD_COLS`` columns."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64)
    for k0 in range(0, a.shape[1], FOLD_COLS):
        acc = a64[:, k0:k0 + FOLD_COLS] @ b64[k0:k0 + FOLD_COLS]
        if acc.numel() and int(acc.abs().max()) >= 2 ** 31:
            raise AssertionError(f"columns {k0}+: s32 sum {int(acc.abs().max())}")
        total = (total + (acc & 0xFFFFFFFF)) & 0xFFFFFFFF
    return (((total + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(INT_DTYPE)
