"""Integer-only arithmetic primitives (port of ``repro.core.numerics``).

Every operation is closed over the integers.  ``⌊·⌋`` is floor division
(rounds toward −∞), never C truncation.  The carrying dtype is int32 and
int32 products wrap mod 2³², as XLA's integer dot does.
"""

from __future__ import annotations

import torch

from repro_torch.core.cost_hook import opaque_product
from repro_torch.obs import trace

INT_DTYPE = torch.int32
# Operational range of NITRO-ReLU / int8 activations (paper §3.2).
ACT_MIN = -127
ACT_MAX = 127


def to_int(x) -> torch.Tensor:
    """Cast to the carrying integer dtype (int32)."""
    return torch.as_tensor(x, dtype=INT_DTYPE)


def floor_div(x: torch.Tensor, d) -> torch.Tensor:
    """Integer floor division ⌊x/d⌋ — rounds toward −∞ like the paper."""
    return torch.div(x, d, rounding_mode="floor")


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 → int32 keeping the low 32 bits (two's complement wrap)."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(INT_DTYPE)


def sum_int32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Integer sum that keeps int32 and wraps mod 2³², as XLA's int32
    reduction does (a torch integer sum promotes to int64)."""
    total = x.sum(dtype=torch.int64) if dim is None else x.sum(dim, dtype=torch.int64)
    return _wrap_int32(total)


def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (int64), as ``jnp.argmax``
    breaks ties; written out so no device's tie rule matters."""
    is_max = x == x.amax(dim, keepdim=True)
    return (is_max.cumsum(dim) == 0).sum(dim)


def _matmul_f64_exact(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int32 product mod 2³² from float64 GEMMs over 16-bit limbs.

    PyTorch has no integer GEMM on CUDA.  Each operand is split as
    v = hi·2¹⁶ + lo (lo ∈ [0, 2¹⁶)); every limb product is < 2³² in
    magnitude, so each float64 GEMM is exact for K < 2²¹, and the hi·hi
    term vanishes mod 2³².
    """
    if a.shape[-1] >= 1 << 21:
        raise ValueError(f"contraction {a.shape[-1]} too long for exact f64 limbs")
    a64, w64 = a.to(torch.int64), w.to(torch.int64)
    a_lo, a_hi = (a64 & 0xFFFF).double(), (a64 >> 16).double()
    w_lo, w_hi = (w64 & 0xFFFF).double(), (w64 >> 16).double()
    lo = (a_lo @ w_lo).to(torch.int64)
    mid = (a_hi @ w_lo + a_lo @ w_hi).to(torch.int64)
    return _wrap_int32(lo + ((mid & 0xFFFF) << 16))


def int_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``int_matmul``: torch's integer ``@`` on the CPU,
    ``_matmul_f64_exact`` on the card.  Not on any main path: the kernels'
    plain versions call it, so that a fault of the card's integer GEMM
    cannot hide on both sides of a parity check."""
    a, w = a.to(INT_DTYPE), w.to(INT_DTYPE)
    if a.device.type == "cpu":
        return a @ w
    return _matmul_f64_exact(a, w)


@trace.spanned("dispatch.int_matmul")
def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Integer matrix product with int32 accumulation (wraps mod 2³²).

    On the CPU both operands are lifted to int32 first (``int8 @ int8``
    returns int8 and wraps there).  On the card it is the hand-written
    integer GEMM (``kernels/int_matmul``), which reads int8 operands as
    they are: no float is computed.  On ``meta`` (the dry run) it computes
    nothing and returns the int32 result's shape.  Under a cost counter
    (``core/cost_hook.py``) each call counts as one product on every
    device, the ops inside it not at all.
    """
    if a.device.type == "cpu":
        def fn():
            return a.to(INT_DTYPE) @ w.to(INT_DTYPE)
    elif a.device.type == "meta":
        def fn():
            return torch.empty((*a.shape[:-1], w.shape[-1]), dtype=INT_DTYPE, device=a.device)
    else:
        from repro_torch.kernels.int_matmul.int_matmul import int_matmul_cuda

        def fn():
            return int_matmul_cuda(a, w)
    return opaque_product("int_matmul", fn, a, w)


def clip_act(x: torch.Tensor) -> torch.Tensor:
    """Clamp to the NITRO operational range [-127, 127]."""
    return torch.clamp(x, ACT_MIN, ACT_MAX)


def isqrt(n) -> torch.Tensor:
    """Integer square root ⌊√n⌋ via a fixed 25 Newton steps, pure integer."""
    n = to_int(n)
    x = n.clamp(1, 46341)  # isqrt of any int32 is ≤ 46340: no overflow
    for _ in range(25):
        x_safe = x.clamp(min=1)
        nxt = floor_div(x_safe + floor_div(n, x_safe), 2)
        x = torch.where(n > 0, torch.minimum(x, nxt), torch.zeros_like(x))
    return torch.where(n > 0, x, torch.zeros_like(x))


def bitwidth_bound(x_bits: int, w_bits: int, fan_in: int) -> int:
    """Paper §3.2 upper bound: b_z = x_bits + w_bits - 1 + ceil(log2(fan_in))."""
    return x_bits + w_bits - 1 + max(int(fan_in - 1).bit_length(), 0)


def assert_int(x: torch.Tensor, name: str = "tensor") -> None:
    if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
        raise TypeError(f"{name} must be integer, got {x.dtype}")
