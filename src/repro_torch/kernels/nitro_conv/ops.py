"""Dispatch for the streaming conv kernels (port of
``repro.kernels.nitro_conv.ops``): ``fused_conv`` (inference),
``fused_conv_fwd`` (training forward), ``conv_grad_w`` (training
weight gradient), ``conv_grad_w_opt`` (the ``fuse_opt`` weight update)
and ``conv_grad_x`` (training input gradient).

``conv_mode``
  * ``'stream'``      — implicit im2col: the CUDA kernel stages row bands
                        in shared memory, the plain version loops over
                        band-local patch blocks; the ``(N·H·W, K²·C)``
                        patch matrix never exists;
  * ``'materialise'`` — explicit im2col + the fused matmul (+ a separate
                        pool), kept as the bit-exact escape hatch.

``backend`` has ``nitro_matmul.ops``' vocabulary: ``auto | cuda |
reference``.  Every (mode, backend) combination gives the same bits.
The materialised training route is plain tensor code around the
matmul dispatchers, as in the JAX package (its patches lie in device
memory anyway, so there is no fusion site: it pre-masks δ).
``conv_grad_w_opt`` is stream-only by design, as in the JAX package: the
materialised gradient has no kernel flush to fuse the optimiser into.

Every entry point takes ``tiles`` (a ``kernels.autotune.TileConfig``),
looked up in the autotune cache under the JAX package's key when
``None``: ``reference`` gives its ``bh`` to the plain stream conv (``None``:
the automatic band); the CUDA kernels have no run-time knob.  A
materialise-mode miss falls through to the inner matmul's own lookup.
"""

from __future__ import annotations

import torch

from repro_torch.core.layers import conv_im2col_operands, im2col, window_view_2x2
from repro_torch.core.numerics import int_matmul
from repro_torch.kernels.autotune import state as autotune
from repro_torch.kernels.autotune.tiles import TileConfig
from repro_torch.kernels.nitro_conv import ref as conv_ref
from repro_torch.kernels.nitro_conv.nitro_conv import (
    stream_conv,
    stream_conv_fwd,
    stream_conv_grad_w,
    stream_conv_grad_w_opt,
    stream_conv_grad_x,
)
from repro_torch.kernels.nitro_matmul.ops import (
    _guard_int8,
    check_alpha_inv,
    fused_matmul,
    fused_matmul_fwd,
    resolve_backend,
    resolve_operand_dtype,
)
from repro_torch.kernels.nitro_matmul.ref import masked_delta
from repro_torch.obs import trace

CONV_MODES = ("stream", "materialise")


def _bh(tiles: TileConfig | None) -> int | None:
    """The plain stream conv's band height (``None``: its automatic band)."""
    return None if tiles is None else tiles.bh


def _conv_key(x: torch.Tensor, k: int, f: int) -> tuple:
    """The conv problems' key shape ``(N, H, W, C, K, F)``."""
    return (x.shape[0], x.shape[1], x.shape[2], x.shape[3], k, f)


def resolve_conv_mode(conv_mode: str) -> str:
    if conv_mode not in CONV_MODES:
        raise ValueError(
            f"unknown conv_mode {conv_mode!r}; one of {CONV_MODES}"
        )
    return conv_mode


@trace.spanned("dispatch.fused_conv")
def fused_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    pool: bool = False,
    out_dtype: torch.dtype = torch.int32,
    backend: str = "auto",
    conv_mode: str = "stream",
    tiles: TileConfig | None = None,
    operand_dtype: str = "auto",
    key_w_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """One fused conv+scale(+relu)(+2×2 pool) — the inference plan step.
    ``key_w_dtype`` as for ``fused_matmul``.

    (N,H,W,C) int × (K,K,C,F) int → (N,H,W,F), or (N,H//2,W//2,F) when
    ``pool=True``.
    """
    alpha_inv = check_alpha_inv(alpha_inv, apply_relu)
    backend = resolve_backend(backend, x.device)
    conv_mode = resolve_conv_mode(conv_mode)
    od = resolve_operand_dtype(operand_dtype, x, w)
    if od == "int8":
        x = _guard_int8(x, "x")
        w = _guard_int8(w, "w")
    if tiles is None:
        tiles = autotune.resolve_tiles(
            "conv", _conv_key(x, w.shape[0], w.shape[-1]),
            dtype=(x.dtype, key_w_dtype or w.dtype), backend=backend, conv_mode=conv_mode)
    if conv_mode == "materialise":
        n, h, w_sp, _ = x.shape
        patches, w_flat = conv_im2col_operands(w, x)
        out = fused_matmul(
            patches, w_flat, sf=sf, alpha_inv=alpha_inv,
            apply_relu=apply_relu, out_dtype=out_dtype, backend=backend,
            tiles=tiles, operand_dtype=od, key_w_dtype=key_w_dtype,
        ).reshape(n, h, w_sp, w.shape[-1])
        return window_view_2x2(out).amax(dim=3) if pool else out
    if backend == "reference":
        return conv_ref.stream_conv_ref(
            x, w, sf=sf, alpha_inv=alpha_inv, apply_relu=apply_relu, pool=pool,
            out_dtype=out_dtype, bh=_bh(tiles), operand_dtype=od,
        )
    return stream_conv(
        x, w, sf=sf, alpha_inv=alpha_inv, apply_relu=apply_relu, pool=pool,
        out_dtype=out_dtype, operand_dtype=od,
    )


@trace.spanned("dispatch.fused_conv_fwd")
def fused_conv_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    backend: str = "auto",
    conv_mode: str = "stream",
    tiles: TileConfig | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused conv training forward: ``(a, z_star)``, both int32 (N,H,W,F).

    ``materialise`` runs the fused matmul forward on explicit im2col
    patches (``nitro_matmul_fwd`` on CUDA tensors).
    """
    alpha_inv = check_alpha_inv(alpha_inv, True)
    backend = resolve_backend(backend, x.device)
    conv_mode = resolve_conv_mode(conv_mode)
    if tiles is None:
        tiles = autotune.resolve_tiles(
            "conv_fwd", _conv_key(x, w.shape[0], w.shape[-1]), dtype=(x.dtype, w.dtype),
            backend=backend, conv_mode=conv_mode)
    if conv_mode == "materialise":
        n, h, w_sp, _ = x.shape
        f = w.shape[-1]
        patches, w_flat = conv_im2col_operands(w, x)
        a2, z2 = fused_matmul_fwd(patches, w_flat, sf=sf, alpha_inv=alpha_inv,
                                  backend=backend, tiles=tiles)
        return a2.reshape(n, h, w_sp, f), z2.reshape(n, h, w_sp, f)
    if backend == "reference":
        return conv_ref.stream_conv_fwd_ref(x, w, sf=sf, alpha_inv=alpha_inv, bh=_bh(tiles))
    return stream_conv_fwd(x, w, sf=sf, alpha_inv=alpha_inv)


@trace.spanned("dispatch.conv_grad_w")
def conv_grad_w(
    x: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    kernel_size: int,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    backend: str = "auto",
    conv_mode: str = "stream",
    tiles: TileConfig | None = None,
) -> torch.Tensor:
    """Conv weight gradient: (N,H,W,C) × (N,H,W,F) → (K,K,C,F) int32.

    ``z_star`` applies the NITRO-ReLU derivative to δ inside the kernel
    (``materialise``: as a pre-mask before ``im2colᵀ @ δ``); without it
    the caller has already applied the activation backward.
    """
    backend = resolve_backend(backend, x.device)
    if z_star is not None:
        alpha_inv = check_alpha_inv(alpha_inv, True)
    conv_mode = resolve_conv_mode(conv_mode)
    if tiles is None and conv_mode != "materialise":
        tiles = autotune.resolve_tiles(
            "conv_grad_w", _conv_key(x, kernel_size, grad_out.shape[-1]),
            dtype=(x.dtype, grad_out.dtype), backend=backend, conv_mode=conv_mode,
            fuse_bwd=z_star is not None)
    if conv_mode == "materialise":
        if z_star is not None:
            grad_out = masked_delta(grad_out, z_star, alpha_inv)
        n, h, w_sp, c = x.shape
        f = grad_out.shape[-1]
        k = kernel_size
        patches = im2col(x, k, k // 2).reshape(n * h * w_sp, k * k * c)
        g_flat = grad_out.reshape(n * h * w_sp, f)
        return int_matmul(patches.T, g_flat).reshape(k, k, c, f)
    if backend == "reference":
        return conv_ref.stream_conv_grad_w_ref(x, grad_out, kernel_size=kernel_size,
                                               z_star=z_star, alpha_inv=alpha_inv,
                                               bh=_bh(tiles))
    return stream_conv_grad_w(x, grad_out, kernel_size=kernel_size, z_star=z_star,
                              alpha_inv=alpha_inv)


@trace.spanned("dispatch.conv_grad_w_opt")
def conv_grad_w_opt(
    x: torch.Tensor,
    grad_out: torch.Tensor,
    w: torch.Tensor,
    gamma_inv,
    eta_inv,
    *,
    kernel_size: int,
    z_star: torch.Tensor,
    alpha_inv: int = 10,
    backend: str = "auto",
    conv_mode: str = "stream",
    tiles: TileConfig | None = None,
) -> torch.Tensor:
    """Conv weight *update*: ``conv_grad_w`` with IntegerSGD applied in the
    streaming kernel's flush — returns W′ (K,K,C,F), grad_W never written.

    Stream-only: ``conv_mode='materialise'`` raises ``ValueError`` (its
    caller, ``grad_ops.conv_weight_update``, takes the unfused escape
    hatch there).  ``z_star`` is required: a caller without it has
    pre-masked δ, which is also the escape hatch's job.
    """
    backend = resolve_backend(backend, x.device)
    alpha_inv = check_alpha_inv(alpha_inv, True)
    if resolve_conv_mode(conv_mode) == "materialise":
        raise ValueError(
            "conv_grad_w_opt is stream-only: the materialise path has no "
            "kernel flush to fuse the optimiser into — compute conv_grad_w "
            "and apply optimizer.apply_update instead"
        )
    if tiles is None:
        tiles = autotune.resolve_tiles(
            "conv_grad_w", _conv_key(x, kernel_size, grad_out.shape[-1]),
            dtype=(x.dtype, grad_out.dtype), backend=backend, conv_mode=conv_mode,
            fuse_bwd=True, fuse_opt=True)
    if backend == "reference":
        return conv_ref.stream_conv_grad_w_opt_ref(
            x, grad_out, z_star, w, gamma_inv, eta_inv, kernel_size=kernel_size,
            alpha_inv=alpha_inv, bh=_bh(tiles))
    return stream_conv_grad_w_opt(x, grad_out, z_star, w, gamma_inv, eta_inv,
                                  kernel_size=kernel_size, alpha_inv=alpha_inv)


@trace.spanned("dispatch.conv_grad_x")
def conv_grad_x(
    grad_out: torch.Tensor,
    w: torch.Tensor,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    backend: str = "auto",
    conv_mode: str = "stream",
    tiles: TileConfig | None = None,
) -> torch.Tensor:
    """Conv input gradient: the 'full' correlation of ``grad_out`` with
    ``rot180_swap(w)``, one more conv with unit scale and no activation.
    (N,H,W,F) × (K,K,C,F) → (N,H,W,C) int32.

    Stream mode with ``z_star`` runs ``stream_conv_grad_x``, which masks δ
    by the NITRO-ReLU derivative as it gathers it; without ``z_star`` (δ
    already masked) the inference kernel ``stream_conv`` at ``sf=1``
    without ReLU.  ``reference`` is the band oracle; ``materialise``
    pre-masks δ and multiplies explicit im2col patches.
    """
    backend = resolve_backend(backend, grad_out.device)
    if z_star is not None:
        alpha_inv = check_alpha_inv(alpha_inv, True)
    conv_mode = resolve_conv_mode(conv_mode)
    if tiles is None and conv_mode != "materialise":
        tiles = autotune.resolve_tiles(
            "conv_grad_x", _conv_key(grad_out, w.shape[0], w.shape[2]),
            dtype=(grad_out.dtype, w.dtype), backend=backend, conv_mode=conv_mode,
            fuse_bwd=z_star is not None)
    if conv_mode == "materialise":
        if z_star is not None:
            grad_out = masked_delta(grad_out, z_star, alpha_inv)
        n, h, w_sp, _ = grad_out.shape
        g_patches, w_rot_flat = conv_im2col_operands(conv_ref.rot180_swap(w), grad_out)
        return int_matmul(g_patches, w_rot_flat).reshape(n, h, w_sp, w.shape[2])
    if backend == "reference":
        return conv_ref.stream_conv_grad_x_ref(grad_out, w, z_star=z_star,
                                               alpha_inv=alpha_inv, bh=_bh(tiles))
    if z_star is not None:
        return stream_conv_grad_x(grad_out, z_star, w, alpha_inv=alpha_inv)
    return stream_conv(grad_out, conv_ref.rot180_swap(w), sf=1, apply_relu=False,
                       pool=False)
