"""Threefry-2x32 random numbers, bit for bit those of ``jax.random``.

The JAX package draws its integer init (``jax.random.randint``) and its
dropout masks (``jax.random.bits``) from threefry2x32 with the
partitionable counter layout (``jax_threefry_partitionable=True``).
``torch.Generator`` gives other numbers from the same seed, so this
module reimplements the four calls the JAX package makes:

  * ``PRNGKey(seed)``        → the key (0, seed);
  * ``split(key, n)``        → row i is threefry(key, counter i);
  * ``bits(key, shape)``     → x0 ^ x1 of threefry(key, counter i) for
                               element i of the flattened shape;
  * ``randint(key, shape, lo, hi)`` → JAX's ``_randint`` on int32.

The counter of element i is the pair (i >> 32, i & 0xffffffff).  A key
is an int64 tensor of shape (2,) on the CPU holding two uint32 words;
the words of a draw are computed in int64 masked to 32 bits on the
draw's device, since torch's uint32 supports little arithmetic.
"""

from __future__ import annotations

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
