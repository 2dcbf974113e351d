"""Gradient compression for the data-parallel all-reduce (port of
``repro.parallel.compress``).

Two regimes, matching the two kinds of gradient that cross a ``data``
axis:

  * **NITRO path** — NITRO-D's gradients are already int32, so the
    cross-rank reduction is an exact integer sum and data-parallel
    training is bit-reproducible whatever the reduction order.
    ``exact_integer_psum`` is the backend's all-reduce;
    ``nitro_compressed_psum`` is the same exact sum over an **int8-limb
    wire format**: each int32 element is split into ``num_limbs`` base-256
    digits carried as int8 planes, the planes are summed with int32 carry
    headroom (safe for ≤ 2²⁴ ranks) and the plane sums recombine to the
    bit-exact int32 total.  As in the JAX package the planes are lifted to
    int32 before the all-reduce, so ``num_limbs=4`` puts four int32 planes
    on the wire: 4× the bytes of ``exact_integer_psum``.  ``num_limbs=2``
    is exact whenever every element fits int16 — the bound that
    ``dp``'s ``grad_fits_int16`` telemetry measures.

  * **FP path** — for float gradients (kept as the comparison baseline):
    int8 quantisation against a per-tensor power-of-two scale with an
    error-feedback residual (EF-SGD).  Approximate by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.numerics import INT_DTYPE
from repro_torch.parallel.collectives import all_reduce
from repro_torch.parallel.tree import leaves, tree_map, unflatten

# ---------------------------------------------------------------------------
# NITRO path: exact integer reduction (int32, or int8-limb wire format)
# ---------------------------------------------------------------------------

_LIMB_BITS = 8
_LIMB_BASE = 1 << _LIMB_BITS  # 256
_LIMB_BIAS = 128              # maps an unsigned digit 0..255 onto int8
_M32 = (1 << 32) - 1


def exact_integer_psum(int_grads, axis):
    """NITRO path: int32 gradients sum exactly; bit-reproducible DP."""
    return tree_map(lambda g: all_reduce(g, axis), int_grads)


def pack_int8_limbs(g: torch.Tensor, num_limbs: int = 4) -> torch.Tensor:
    """int32 tensor → ``(num_limbs, *shape)`` int8 limb planes.

    Little-endian base-256 digits: low limbs are unsigned digits biased by
    −128 onto the int8 range; the top limb is the arithmetic shift
    remainder (sign-carrying, unbiased).  Exact round trip iff every
    element fits ``8·num_limbs`` signed bits — always for ``num_limbs=4``;
    for fewer limbs the top limb wraps to int8 and ``fits_limbs`` is the
    caller's check.
    """
    if not 1 <= num_limbs <= 4:
        raise ValueError(f"num_limbs must be in 1..4, got {num_limbs}")
    g = g.to(INT_DTYPE)
    limbs = [((g >> (_LIMB_BITS * k)) & (_LIMB_BASE - 1)) - _LIMB_BIAS
             for k in range(num_limbs - 1)]
    limbs.append(g >> (_LIMB_BITS * (num_limbs - 1)))  # signed top limb
    return torch.stack(limbs).to(torch.int8)


def unpack_limb_sums(limb_sums: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Recombine per-limb int32 *sums* into the summed int32 tensor.

    ``limb_sums[k]`` is Σ over shards of the biased int8 limb *k*.
    Linearity gives Σg = Σ_k 256^k·(plane-k sum, bias restored), taken
    mod 2³² as the JAX package's int32 shifts wrap.  A left shift of a
    negative int32 is undefined in C++, so the sum is formed in int64
    (every term is below 2⁵⁶) and its low 32 bits read back as int32.
    """
    s = limb_sums.to(torch.int64)
    num_limbs = s.shape[0]
    total = s[num_limbs - 1] * (1 << (_LIMB_BITS * (num_limbs - 1)))
    for k in range(num_limbs - 1):
        total = total + (s[k] + num_shards * _LIMB_BIAS) * (1 << (_LIMB_BITS * k))
    total = total & _M32
    return (total - ((total >> 31) << 32)).to(INT_DTYPE)


def fits_limbs(g: torch.Tensor, num_limbs: int) -> torch.Tensor:
    """0-dim bool: every element representable in ``8·num_limbs`` signed
    bits (the exactness precondition of a truncated-limb encoding)."""
    bound = 1 << (_LIMB_BITS * num_limbs - 1)
    g = g.to(INT_DTYPE)
    return ((g >= -bound) & (g <= bound - 1)).all()


def nitro_compressed_psum(int_grads, axis, *, num_limbs: int = 4):
    """Exact all-reduce of an int32 gradient tree over int8 limb planes.

    Per tensor: pack into int8 limb planes, lift each plane to int32
    (carry headroom: 255·N ≪ 2³¹), all-reduce the planes, recombine.
    Bitwise ``exact_integer_psum`` whenever every local element fits
    ``8·num_limbs`` signed bits — unconditionally at the default 4.
    """
    def reduce_one(g: torch.Tensor) -> torch.Tensor:
        lifted = pack_int8_limbs(g, num_limbs).to(INT_DTYPE)
        summed = all_reduce(lifted, axis)
        return unpack_limb_sums(summed, axis.size).to(g.dtype)

    return tree_map(reduce_one, int_grads)


# ---------------------------------------------------------------------------
# FP path: EF-int8 quantisation (float gradients only — approximate)
# ---------------------------------------------------------------------------


class EFState(NamedTuple):
    """Error-feedback residual, the same tree structure as the gradients."""

    residual: object


def ef_init(grads) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads))


def _quantize_one(g: torch.Tensor, r: torch.Tensor):
    """(int8 payload, pow2 scale, new residual) for one tensor."""
    gf = g.to(torch.float32) + r
    amax = gf.abs().max()
    shift = torch.ceil(torch.log2(torch.clamp(amax / 127.0, min=1e-30)))
    scale = torch.ldexp(torch.ones((), dtype=torch.float32, device=g.device), shift)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    new_r = gf - q * scale
    return q.to(torch.int8), scale, new_r


def compress(grads, ef: EFState):
    """Quantise a gradient tree to (int8, scale) pairs + the new EF state."""
    out = [_quantize_one(g, r) for g, r in zip(leaves(grads), leaves(ef.residual),
                                               strict=True)]
    return (unflatten(grads, [q for q, _, _ in out]),
            unflatten(grads, [s for _, s, _ in out]),
            EFState(residual=unflatten(grads, [r for _, _, r in out])))


def decompress(qgrads, scales):
    return tree_map(lambda q, s: q.to(torch.float32) * s, qgrads, scales)


def compressed_psum(grads, ef: EFState, axis):
    """EF-int8 all-reduce over ``axis``: int8 payloads summed in int32 (no
    overflow for ≤ 2²⁴ ranks), per-tensor scales maxed so every rank
    dequantises alike."""
    q, s, ef = compress(grads, ef)
    s_max = tree_map(lambda x: all_reduce(x, axis, "max"), s)
    # requantise against the global scale so payload sums are consistent
    q = tree_map(
        lambda qq, ss, sm: torch.clamp(
            torch.round(qq.to(torch.float32) * ss / sm), -127, 127).to(INT_DTYPE),
        q, s, s_max)
    summed = tree_map(lambda x: all_reduce(x, axis), q)
    return decompress(summed, s_max), ef
