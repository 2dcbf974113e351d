"""Dispatch for the NITRO matmul kernels (port of
``repro.kernels.nitro_matmul.ops``): ``fused_matmul`` (inference),
``fused_matmul_fwd`` (training forward), ``grad_w_matmul`` (training
weight gradient), ``grad_w_opt_matmul`` (the ``fuse_opt`` weight
update) and ``grad_x_matmul`` (training input gradient); and the legacy
fused-layer wrappers ``nitro_linear`` / ``nitro_conv2d`` over
``fused_matmul``.

Backends:

  * ``'cuda'``      — the hand-written kernels (``nitro_matmul.py``);
  * ``'reference'`` — the plain PyTorch version (``ref.py``), on any device;
  * ``'auto'``      — ``cuda`` for CUDA tensors, ``reference`` for CPU ones.

``'cuda'`` on a CPU tensor raises; nothing falls back to another backend.

Every entry point takes ``tiles`` (a ``kernels.autotune.TileConfig``):
``None`` looks the problem up in the process-wide autotune cache, under
the JAX package's key, and counts the hit or miss.  No matmul has a
run-time knob (the kernels' tiles are compiled in, the plain versions
have none), so the tiles change nothing here; a tile choice never changes
a result.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.core.layers import conv_im2col_operands
from repro_torch.core.scaling import conv_scale_factor, linear_scale_factor
from repro_torch.kernels.autotune import state as autotune
from repro_torch.kernels.autotune.tiles import TileConfig
from repro_torch.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul,
    nitro_matmul_fwd,
    nitro_matmul_grad_w,
    nitro_matmul_grad_w_opt,
    nitro_matmul_grad_x,
)
from repro_torch.kernels.nitro_matmul.ref import (
    nitro_matmul_fwd_ref,
    nitro_matmul_grad_w_opt_ref,
    nitro_matmul_grad_w_ref,
    nitro_matmul_grad_x_ref,
    nitro_matmul_ref,
)

BACKENDS = ("auto", "cuda", "reference")

#: Operand-dtype policy for the inference matmuls:
#:   * ``'auto'``  — int8 operands stay int8 whenever both already are;
#:                   anything else lifts to int32.  Never changes results.
#:   * ``'int8'``  — force the int8 path: wider operands are checked to lie
#:                   in [-127, 127] and narrowed, else it raises.
#:   * ``'int32'`` — always lift.
OPERAND_DTYPES = ("auto", "int8", "int32")


def _guard_int8(arr: torch.Tensor, name: str) -> torch.Tensor:
    """Forced-int8 path: prove |v| ≤ 127 for every value, then narrow."""
    if arr.dtype == torch.int8:
        return arr
    if arr.numel() and (int(arr.min()) < -127 or int(arr.max()) > 127):
        raise ValueError(
            f"operand_dtype='int8': operand {name!r} has values outside "
            f"[-127, 127] — values do not fit int8; use the int32 escape hatch"
        )
    return arr.to(torch.int8)


def resolve_operand_dtype(
    operand_dtype: str, x: torch.Tensor, w: torch.Tensor
) -> str:
    """Resolve the ``'auto'`` policy to a concrete ``'int8'``/``'int32'``."""
    if operand_dtype not in OPERAND_DTYPES:
        raise ValueError(
            f"unknown operand_dtype {operand_dtype!r}; one of {OPERAND_DTYPES}"
        )
    if operand_dtype == "auto":
        both = x.dtype == torch.int8 and w.dtype == torch.int8
        return "int8" if both else "int32"
    return operand_dtype


def resolve_backend(backend: str, device) -> str:
    """Validate + resolve ``'auto'`` for tensors on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    is_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "cuda" if is_cuda else "reference"
    if backend == "cuda" and not is_cuda:
        raise ValueError(
            f"backend='cuda' needs CUDA tensors, got device {str(device)!r}"
        )
    return backend


def check_alpha_inv(alpha_inv: int, apply_relu: bool) -> int:
    """Validate the NITRO-ReLU leak divisor ``α_inv = ⌊1/α⌋``.

    0 would divide by zero inside the kernel, so it raises.  Without the
    ReLU the value is unused and normalised to 1 (frozen output layers are
    exported with ``alpha_inv=0``).
    """
    if not apply_relu:
        return 1
    if int(alpha_inv) < 1:
        raise ValueError(
            f"alpha_inv must be a positive integer when apply_relu=True, "
            f"got {alpha_inv!r}"
        )
    return int(alpha_inv)


def fused_matmul(
    x2: torch.Tensor,
    w2: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    out_dtype: torch.dtype = torch.int32,
    backend: str = "auto",
    tiles: TileConfig | None = None,
    operand_dtype: str = "auto",
    key_w_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """One fused matmul+scale(+relu) on 2-D operands — the inference step.

    ``key_w_dtype`` is the weight dtype the autotune key names (default
    w2's): a plan that holds an int32 copy of an int8 frozen weight keys
    it as int8, as the JAX plan does."""
    backend = resolve_backend(backend, x2.device)
    alpha_inv = check_alpha_inv(alpha_inv, apply_relu)
    od = resolve_operand_dtype(operand_dtype, x2, w2)
    if od == "int8":
        x2 = _guard_int8(x2, "x")
        w2 = _guard_int8(w2, "w")
    if tiles is None:
        autotune.resolve_tiles(
            "matmul", (x2.shape[0], x2.shape[1], w2.shape[1]),
            dtype=(x2.dtype, key_w_dtype or w2.dtype), backend=backend)
    fn = nitro_matmul_ref if backend == "reference" else nitro_matmul
    return fn(
        x2, w2, sf=sf, alpha_inv=alpha_inv, apply_relu=apply_relu,
        out_dtype=out_dtype, operand_dtype=od,
    )


def fused_matmul_fwd(
    x2: torch.Tensor,
    w2: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    backend: str = "auto",
    tiles: TileConfig | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused training forward on 2-D operands: ``(a, z_star)``, both int32.

    Training operands are int32 (the JAX package's dtype contract), so
    there is no ``operand_dtype`` here.
    """
    backend = resolve_backend(backend, x2.device)
    alpha_inv = check_alpha_inv(alpha_inv, True)
    if tiles is None:
        autotune.resolve_tiles(
            "matmul_fwd", (x2.shape[0], x2.shape[1], w2.shape[1]),
            dtype=(x2.dtype, w2.dtype), backend=backend)
    fn = nitro_matmul_fwd_ref if backend == "reference" else nitro_matmul_fwd
    return fn(x2, w2, sf=sf, alpha_inv=alpha_inv)


def grad_w_matmul(
    x2: torch.Tensor,
    delta2: torch.Tensor,
    z_star2: torch.Tensor,
    *,
    alpha_inv: int = 10,
    backend: str = "auto",
    tiles: TileConfig | None = None,
) -> torch.Tensor:
    """Fused weight gradient ``x2ᵀ @ relu_bwd(z*, δ)``, the NITRO-ReLU
    derivative applied to δ as the kernel loads it."""
    backend = resolve_backend(backend, x2.device)
    alpha_inv = check_alpha_inv(alpha_inv, True)
    if tiles is None:
        autotune.resolve_tiles(
            "matmul_grad_w", (x2.shape[0], x2.shape[1], delta2.shape[1]),
            dtype=(x2.dtype, delta2.dtype), backend=backend, fuse_bwd=True)
    fn = nitro_matmul_grad_w_ref if backend == "reference" else nitro_matmul_grad_w
    return fn(x2, delta2, z_star2, alpha_inv=alpha_inv)


def grad_w_opt_matmul(
    x2: torch.Tensor,
    delta2: torch.Tensor,
    z_star2: torch.Tensor,
    w2: torch.Tensor,
    gamma_inv,
    eta_inv,
    *,
    alpha_inv: int = 10,
    backend: str = "auto",
    tiles: TileConfig | None = None,
) -> torch.Tensor:
    """Fused weight *update* on 2-D operands: returns W′.

    ``cuda`` runs ``nitro_matmul_grad_w_opt`` (IntegerSGD in the grad_W
    kernel's flush, grad_W never written); ``reference`` composes the
    plain gradient with ``integer_sgd_ref`` — the same bits, as floor
    division of an exact int32 sum is exact.
    """
    backend = resolve_backend(backend, x2.device)
    alpha_inv = check_alpha_inv(alpha_inv, True)
    if tiles is None:
        autotune.resolve_tiles(
            "matmul_grad_w", (x2.shape[0], x2.shape[1], delta2.shape[1]),
            dtype=(x2.dtype, delta2.dtype), backend=backend, fuse_bwd=True,
            fuse_opt=True)
    fn = (nitro_matmul_grad_w_opt_ref if backend == "reference"
          else nitro_matmul_grad_w_opt)
    return fn(x2, delta2, z_star2, w2, gamma_inv, eta_inv, alpha_inv=alpha_inv)


def grad_x_matmul(
    delta2: torch.Tensor,
    z_star2: torch.Tensor,
    w2: torch.Tensor,
    *,
    alpha_inv: int = 10,
    backend: str = "auto",
    tiles: TileConfig | None = None,
) -> torch.Tensor:
    """Fused input gradient ``relu_bwd(z*, δ) @ w2ᵀ`` on 2-D operands, the
    NITRO-ReLU derivative applied to δ as the kernel loads it and w2 read
    in its natural (fan_in, fan_out) layout."""
    backend = resolve_backend(backend, delta2.device)
    alpha_inv = check_alpha_inv(alpha_inv, True)
    if tiles is None:
        autotune.resolve_tiles(
            "matmul_grad_x", (delta2.shape[0], delta2.shape[1], w2.shape[0]),
            dtype=(delta2.dtype, w2.dtype), backend=backend, fuse_bwd=True)
    fn = nitro_matmul_grad_x_ref if backend == "reference" else nitro_matmul_grad_x
    return fn(delta2, z_star2, w2, alpha_inv=alpha_inv)


def _legacy_backend(use_kernel: bool | None, interpret: bool | None) -> str:
    """Map the JAX package's deprecated ``use_kernel``/``interpret`` knobs
    to a backend, with its warning and its error.

    Passing either knob warns.  ``use_kernel=False`` with ``interpret=True``
    is contradictory and raises.  The port has no interpreter: the plain
    version (``'reference'``) stands in for an interpreted kernel, so
    ``interpret=True`` selects it; ``use_kernel=True`` with
    ``interpret=False`` is the kernel (``'cuda'``), and otherwise ``'auto'``
    (the kernel on the card, the plain version on the CPU).
    """
    if use_kernel is not None or interpret is not None:
        warnings.warn(
            "use_kernel/interpret are deprecated; use backend="
            "'cuda'|'reference'|'auto' instead",
            DeprecationWarning,
            stacklevel=3,
        )
    if use_kernel is False and interpret:
        raise ValueError(
            "contradictory legacy knobs: use_kernel=False disables the "
            "kernel but interpret=True requests an interpreted kernel; "
            "pass backend='reference' or backend='cuda' instead"
        )
    if use_kernel is False or interpret:
        return "reference"
    if use_kernel and interpret is False:
        return "cuda"
    return "auto"


def nitro_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    out_dtype: torch.dtype = torch.int32,
    use_kernel: bool | None = None,
    interpret: bool | None = None,
) -> torch.Tensor:
    """Fused integer linear layer: ``nitro_relu(⌊(x@w)/(2⁸·M)⌋)``.

    Accepts any leading batch dims on ``x``; contracts the last one.  The
    legacy wrapper over ``fused_matmul`` (``use_kernel``/``interpret`` are
    deprecated, as in the JAX package).
    """
    m = x.shape[-1]
    lead = x.shape[:-1]
    out = fused_matmul(
        x.reshape(-1, m), w, sf=linear_scale_factor(m), alpha_inv=alpha_inv,
        apply_relu=apply_relu, out_dtype=out_dtype,
        backend=_legacy_backend(use_kernel, interpret),
    )
    return out.reshape(*lead, w.shape[-1])


def nitro_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    out_dtype: torch.dtype = torch.int32,
    use_kernel: bool | None = None,
    interpret: bool | None = None,
) -> torch.Tensor:
    """Fused integer conv layer via im2col + ``fused_matmul``.

    x: (N,H,W,C) int, w: (K,K,C,F) int → (N,H,W,F) activations.  The
    legacy wrapper (``use_kernel``/``interpret`` deprecated, as in JAX).
    """
    k = w.shape[0]
    c_in = x.shape[-1]
    n, h, ww, _ = x.shape
    patches, w_flat = conv_im2col_operands(w, x)
    out = fused_matmul(
        patches, w_flat, sf=conv_scale_factor(k, c_in), alpha_inv=alpha_inv,
        apply_relu=apply_relu, out_dtype=out_dtype,
        backend=_legacy_backend(use_kernel, interpret),
    )
    return out.reshape(n, h, ww, w.shape[-1])
