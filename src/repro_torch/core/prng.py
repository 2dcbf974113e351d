"""Threefry-2x32 random numbers, bit for bit those of ``jax.random``.

The JAX package draws its integer init (``jax.random.randint``) and its
dropout masks (``jax.random.bits``) from threefry2x32 with the
partitionable counter layout (``jax_threefry_partitionable=True``).
``torch.Generator`` gives other numbers from the same seed, so this
module reimplements the calls the JAX package makes:

  * ``PRNGKey(seed)``        → the key (0, seed);
  * ``split(key, n)``        → row i is threefry(key, counter i);
  * ``bits(key, shape)``     → x0 ^ x1 of threefry(key, counter i) for
                               element i of the flattened shape;
  * ``randint(key, shape, lo, hi)`` → JAX's ``_randint`` on int32;
  * ``uniform(key, shape, lo, hi)`` / ``bernoulli(key, p, shape)`` →
    JAX's float32 ``_uniform`` / ``_bernoulli`` (the FP baselines' He
    init and dropout).

The counter of element i is the pair (i >> 32, i & 0xffffffff).  A key
is an int64 tensor of shape (2,) on the CPU holding two uint32 words;
the words of a draw are computed in int64 masked to 32 bits on the
draw's device, since torch's uint32 supports little arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802  (jax.random's name)
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0, seed)."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def _key_words(key: torch.Tensor) -> tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"a key has shape (2,), got {tuple(key.shape)}")
    k0, k1 = (int(v) for v in key.tolist())
    if not (0 <= k0 <= _M32 and 0 <= k1 <= _M32):
        raise ValueError(f"key words must be uint32, got {k0}, {k1}")
    return k0, k1


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block cipher on counter words (x0, x1).

    ``x0``/``x1`` are int64 tensors of uint32 values; so are the outputs.
    """
    k0, k1 = _key_words(key)
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


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: an (n, 2) int64 tensor of keys."""
    hi, lo = _counters(n, "cpu")
    x0, x1 = threefry2x32(key, hi, lo)
    return torch.stack([x0, x1], dim=1)


def bits(key: torch.Tensor, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``, as int64 values in [0, 2³²)."""
    shape = tuple(int(d) for d in shape)
    hi, lo = _counters(_numel(shape), device)
    x0, x1 = threefry2x32(key, hi, lo)
    return (x0 ^ x1).reshape(shape)


def randint(key: torch.Tensor, shape, lo: int, hi: int, *,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi, int32)``: int32 in [lo, hi).

    JAX draws two words per element from the halves of ``split(key)`` and
    reduces them mod span = hi − lo in uint32 arithmetic:
    ``((higher % span) · m + lower % span) % span`` with
    m = (2¹⁶ mod span)² mod span.  Every product and sum wraps mod 2³² as
    uint32 does — so for span > 2¹⁶ the square wraps to 0 and m = 0.
    """
    lo, hi = int(lo), int(hi)
    if not (-(2 ** 31) <= lo < 2 ** 31 and -(2 ** 31) <= hi < 2 ** 31):
        raise ValueError(f"randint bounds [{lo}, {hi}) must fit int32")
    k_hi, k_lo = split(key, 2)
    higher = bits(k_hi, shape, device=device)
    lower = bits(k_lo, shape, device=device)
    span = hi - lo if hi > lo else 1
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    # int64 products may wrap past 2⁶³; their low 32 bits stay exact
    offset = (((higher % span) * mult) & _M32) + lower % span
    offset = (offset & _M32) % span
    return (offset + lo).to(torch.int32)


def _fma_f32(f: torch.Tensor, d: np.float32, c: np.float32) -> torch.Tensor:
    """float32 ``f·d + c`` rounded once, as a fused multiply-add gives it.

    XLA's CPU backend contracts ``_uniform``'s multiply-add into one fma,
    so the reference rounds once; float32 ``f * d + c`` in torch rounds
    twice.  ``f·d`` of two float32 values is exact in float64 (48 bits);
    the float64 sum may round, so its error (TwoSum, exact) decides a
    round-to-odd fix-up: an inexact sum whose last bit is even moves one
    float64 ulp toward the exact value.  A round-to-odd float64 rounds to
    float32 (24 bits, 53 ≥ 24 + 2) as the exact value does, so the result
    is the fma's on every device.
    """
    prod = f.double() * float(d)
    s = prod + float(c)
    bb = s - prod
    err = (prod - (s - bb)) + (float(c) - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def uniform(key: torch.Tensor, shape, lo: float = 0.0, hi: float = 1.0, *,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)``, bit for bit.

    The top 23 bits of each word become a float in [1, 2) (exponent of
    1.0), minus 1; then ``max(lo, f·(hi − lo) + lo)`` with ``lo``, ``hi``
    and ``hi − lo`` float32 and the multiply-add rounded once.
    """
    if torch.device(device).type == "meta":  # the dry run: a draw is its shape alone
        return torch.empty(tuple(int(d) for d in shape), dtype=torch.float32, device=device)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = np.float32(hi32 - lo32)
    mant = (bits(key, shape, device=device) >> 9) | 0x3F800000
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    v = _fma_f32(f, span, lo32)
    return torch.maximum(v, torch.tensor(lo32, dtype=torch.float32, device=v.device))


def bernoulli(key: torch.Tensor, p: float, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode ``"low"``), bit for
    bit: ``uniform(key, shape) < float32(p)``, a bool tensor."""
    return uniform(key, shape, device=device) < float(np.float32(p))


def normal(key: torch.Tensor, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: √2 · erfinv(u), u drawn by
    ``uniform`` on [nextafter(−1, 0), 1) bit for bit as JAX draws it.

    ``torch.erfinv`` is not XLA's float32 polynomial: the two agree to a
    few float32 ulps (``tests/test_torch_lm_models.py`` states the bound),
    not bit for bit.
    """
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, float(lo), 1.0, device=device)
    return torch.erfinv(u) * torch.tensor(np.float32(np.sqrt(2)), device=u.device)
