"""Plain PyTorch versions of the streaming implicit-im2col conv kernels
(port of ``repro.kernels.nitro_conv.ref``): the inference step, the
training forward ``(a, z*)``, the weight gradient, the weight update and
the input gradient; and plain models of the kernels' arithmetic on the
card, exact int8 digit products: the conv grad_W kernels
(``patch_digit_planes`` to ``stream_conv_grad_w_opt_digits``), the
forward convs (``x_digit_planes`` to ``stream_conv_fwd_digits``) and the
input gradient (``rot_w_digit_planes``, ``stream_conv_grad_x_digits``).

Each runs the algorithm in plain tensor ops: a loop over output-row
bands, each forming a band-local patch block from K² overlapping row
slices and feeding one integer matmul.  The full ``(N·H·W, K²·C)`` patch
matrix is never formed.  Patch layout matches ``core.layers.im2col``:
segment ``(ki, kj)`` at channels ``[(ki·K + kj)·C, …)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.activations import nitro_relu, nitro_relu_backward
from repro_torch.core.layers import im2col, window_view_2x2
from repro_torch.core.numerics import INT_DTYPE, int_matmul
from repro_torch.core.scaling import scale_forward
from repro_torch.kernels.digit_planes import (  # noqa: F401  (re-exported)
    N_DIGITS,
    PIXEL_TILE,
    digits_needed,
    padded_planes,
    s8_digits,
    x_fits_s8,
)
from repro_torch.kernels.integer_sgd.ref import integer_sgd_ref

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


def _stream_z_bands(
    x: torch.Tensor,
    w: torch.Tensor,
    bh: int | None,
    *,
    pool: bool = False,
    relu_bwd_z: torch.Tensor | None = None,
    relu_bwd_alpha_inv: int = 10,
):
    """Yield the raw int32 pre-activation bands z, each (N, bh, W, F).

    ``relu_bwd_z`` is the grad_x prologue: each row band of ``x`` (the
    incoming δ) is masked by the NITRO-ReLU derivative against the same
    band of ``z_star`` before its patches are formed, so the masked δ
    exists one band at a time.  The zero halo stays zero:
    relu_bwd(z*=0, δ=0) = 0.
    """
    n, h, w_sp, c = x.shape
    k, f = w.shape[0], w.shape[-1]
    bh, h_pad, p = conv_geometry(h, k, bh, pool=pool)
    pad = (0, 0, p, p, p, p + h_pad - h)
    xp = F.pad(x, pad)
    zp = None if relu_bwd_z is None else F.pad(relu_bwd_z, pad)
    w_flat = w.reshape(k * k * c, f)
    for t in range(h_pad // bh):
        band = xp[:, t * bh:t * bh + bh + 2 * p]
        if zp is not None:
            band = nitro_relu_backward(zp[:, t * bh:t * bh + bh + 2 * p], band,
                                       relu_bwd_alpha_inv)
        yield int_matmul(_band_patches(band, k, w_sp), w_flat).reshape(n, bh, w_sp, f)


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
    relu_bwd_z: torch.Tensor | None = None,
    relu_bwd_alpha_inv: int = 10,
) -> torch.Tensor:
    """Streaming fused conv: scale(+relu)(+2×2 maxpool), activation only.

    (N,H,W,C) int × (K,K,C,F) int → (N,H,W,F), or (N,H//2,W//2,F) with
    ``pool=True``.  Products are lifted to int32 whatever
    ``operand_dtype`` says (``'int8'`` only checks the operand dtypes).
    ``relu_bwd_z`` masks each streamed band of ``x`` by the NITRO-ReLU
    derivative first (the grad_x prologue, see ``_stream_z_bands``).
    """
    if operand_dtype == "int8" and not (
        x.dtype == torch.int8 and w.dtype == torch.int8
    ):
        raise ValueError(
            f"operand_dtype='int8' requires int8 operands, got "
            f"{x.dtype}/{w.dtype}"
        )
    h = x.shape[1]
    outs = []
    for z in _stream_z_bands(x, w, bh, pool=pool, relu_bwd_z=relu_bwd_z,
                             relu_bwd_alpha_inv=relu_bwd_alpha_inv):
        a = scale_forward(z, sf)
        if apply_relu:
            a = nitro_relu(a, alpha_inv)
        if pool:
            a = window_view_2x2(a).amax(dim=3)
        outs.append(a.to(out_dtype))
    out = torch.cat(outs, dim=1)
    return out[:, : h // 2] if pool else out[:, :h]


def stream_conv_fwd_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    out_dtype: torch.dtype = torch.int32,
    bh: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming training forward: ``(a, z_star)``, both (N,H,W,F); z_star
    is int32 (the NITRO-ReLU/STE backward's cache)."""
    h = x.shape[1]
    z = torch.cat(list(_stream_z_bands(x, w, bh)), dim=1)
    z_star = scale_forward(z[:, :h], sf)
    return nitro_relu(z_star, alpha_inv).to(out_dtype), z_star


def stream_conv_grad_w_ref(
    x: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    kernel_size: int,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    bh: int | None = None,
) -> torch.Tensor:
    """Streaming weight gradient Σ_bands patch_bandᵀ @ relu_bwd(g_band).

    (N,H,W,C) input × (N,H,W,F) grad → (K,K,C,F) int32.  With ``z_star``
    each gradient band is masked by the NITRO-ReLU derivative before its
    matmul; without it δ is taken as it is.
    """
    n, h, w_sp, c = x.shape
    k = kernel_size
    f = grad_out.shape[-1]
    bh, h_pad, p = conv_geometry(h, k, bh, pool=False)
    xp = F.pad(x.to(INT_DTYPE), (0, 0, p, p, p, p + h_pad - h))
    gp = F.pad(grad_out.to(INT_DTYPE), (0, 0, 0, 0, 0, h_pad - h))
    zp = None if z_star is None else F.pad(z_star, (0, 0, 0, 0, 0, h_pad - h))
    grad_w = torch.zeros((k * k * c, f), dtype=INT_DTYPE, device=x.device)
    for t in range(h_pad // bh):
        patches = _band_patches(xp[:, t * bh:t * bh + bh + 2 * p], k, w_sp)
        g_band = gp[:, t * bh:t * bh + bh]
        if zp is not None:
            g_band = nitro_relu_backward(zp[:, t * bh:t * bh + bh], g_band, alpha_inv)
        grad_w = grad_w + int_matmul(patches.T, g_band.reshape(n * bh * w_sp, f))
    return grad_w.reshape(k, k, c, f)


def stream_conv_grad_w_opt_ref(
    x: torch.Tensor,
    grad_out: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    gamma_inv,
    eta_inv,
    *,
    kernel_size: int,
    alpha_inv: int = 10,
    bh: int | None = None,
) -> torch.Tensor:
    """Weight update: ``stream_conv_grad_w_ref`` (δ masked by z*) then
    IntegerSGD → W′ (K,K,C,F) int32."""
    grad_w = stream_conv_grad_w_ref(x, grad_out, kernel_size=kernel_size,
                                    z_star=z_star, alpha_inv=alpha_inv, bh=bh)
    return integer_sgd_ref(w, grad_w, gamma_inv, eta_inv)


def rot180_swap(w: torch.Tensor) -> torch.Tensor:
    """(K,K,C,F) → (K,K,F,C): the kernel rotated 180° with its channels
    swapped — the weight of the 'full' correlation that computes grad_x."""
    return torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2)


def stream_conv_grad_x_ref(
    grad_out: torch.Tensor,
    w: torch.Tensor,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    bh: int | None = None,
) -> torch.Tensor:
    """Streaming input gradient: the 'full' correlation of δ with
    ``rot180_swap(w)``, a unit-scale conv without activation.

    (N,H,W,F) δ × (K,K,C,F) w → (N,H,W,C) int32.  With ``z_star`` each
    streamed δ band is masked by the NITRO-ReLU derivative before its
    patches are formed.
    """
    return stream_conv_ref(
        grad_out, rot180_swap(w), sf=1, apply_relu=False, pool=False, bh=bh,
        relu_bwd_z=z_star, relu_bwd_alpha_inv=alpha_inv,
    )


# ---------------------------------------------------------------------------
# The conv grad_W kernels' arithmetic (csrc_common/digit_gemm.cuh), in
# plain tensor ops: int32 operands as signed base-256 digits, int8 digit
# planes laid out pixel-contiguous, and only the digit products the data
# needs.  Bitwise the same function as stream_conv_grad_w_ref.
# ---------------------------------------------------------------------------

def patch_digit_planes(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """The x pre-pass: the im2col patch matrix of x (N,H,W,C), transposed
    to (K·K·C, N·H·W) rows m = (ki·K + kj)·C + c, as digit planes
    (nx, M, Pp): one plane when ``x_fits_s8``, else four."""
    n, h, w_sp, c = x.shape
    k = kernel_size
    patches = im2col(x.to(INT_DTYPE), k, k // 2).reshape(n * h * w_sp, k * k * c)
    return padded_planes(patches.T, 1 if x_fits_s8(x) else N_DIGITS)


def delta_digit_planes(grad_out: torch.Tensor, z_star: torch.Tensor | None = None,
                       alpha_inv: int = 10) -> tuple[torch.Tensor, int]:
    """The δ pre-pass: δ (N,H,W,F), masked by the NITRO-ReLU derivative
    when ``z_star`` is given, as four digit planes (4, F, Pp), and the
    digits it needs."""
    g = grad_out.to(INT_DTYPE)
    if z_star is not None:
        g = nitro_relu_backward(z_star, g, alpha_inv)
    rows = g.reshape(-1, g.shape[-1]).T
    return padded_planes(rows, N_DIGITS), digits_needed(g)


def digit_grad_w(xa: torch.Tensor, db: torch.Tensor, nd: int) -> torch.Tensor:
    """The GEMM: Σ_{i+j ≤ 3, j < nd} 2^(8(i+j)) · XA_i · DB_jᵀ (mod 2^32)
    over the (nx, M, Pp) and (4, F, Pp) digit planes → (M, F) int32.

    Each digit product is an s8×s8 sum (exact in int32 here: |Σ| ≤ 2^14
    per pixel); the shifted sums combine in int64 and wrap to int32.
    """
    acc = torch.zeros((xa.shape[1], db.shape[1]), dtype=torch.int64, device=xa.device)
    for i in range(xa.shape[0]):
        for j in range(nd):
            if i + j < N_DIGITS:
                prod = int_matmul(xa[i].to(INT_DTYPE), db[j].to(INT_DTYPE).T)
                acc += prod.to(torch.int64) << (8 * (i + j))
    return (((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(INT_DTYPE)


def stream_conv_grad_w_digits(
    x: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    kernel_size: int,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """``stream_conv_grad_w_ref`` computed as the CUDA kernel computes it:
    digit planes of x's patches and of masked δ, then only the digit
    products the data needs → (K,K,C,F) int32."""
    n, h, w_sp, c = x.shape
    k, f = kernel_size, grad_out.shape[-1]
    db, nd = delta_digit_planes(grad_out, z_star, alpha_inv)
    return digit_grad_w(patch_digit_planes(x, k), db, nd).reshape(k, k, c, f)


def stream_conv_grad_w_opt_digits(
    x: torch.Tensor,
    grad_out: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    gamma_inv,
    eta_inv,
    *,
    kernel_size: int,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """``stream_conv_grad_w_opt_ref`` as the CUDA kernel computes it: the
    digit-product gradient, then IntegerSGD on the whole sum → W′."""
    grad_w = stream_conv_grad_w_digits(x, grad_out, kernel_size=kernel_size,
                                       z_star=z_star, alpha_inv=alpha_inv)
    return integer_sgd_ref(w, grad_w, gamma_inv, eta_inv)


# ---------------------------------------------------------------------------
# The forward conv kernels' arithmetic (csrc_common/conv_digits.cuh): x and
# w as int8 digit planes, the GEMM rows in pool-window order when the pool
# is fused, only the digit products the data needs, s32 sums folded every
# 16,384 columns.  Bitwise the same functions as stream_conv_ref and
# stream_conv_fwd_ref.
# ---------------------------------------------------------------------------

#: Patch columns the forward digit GEMM stages at once (its planes are
#: padded to a multiple), and the most it sums in s32 before a fold.
STAGE_COLS = 64
FOLD_COLS = 16384


def _pad_cols(rows: torch.Tensor) -> torch.Tensor:
    """(..., M) → (..., Mp) with zero columns up to a multiple of 64."""
    m = rows.shape[-1]
    return F.pad(rows, (0, -(-m // STAGE_COLS) * STAGE_COLS - m))


def x_digit_planes(x: torch.Tensor, kernel_size: int) -> tuple[torch.Tensor, int, bool]:
    """The x pre-pass: ``(planes, digits x needs, patch)``.

    With 16 | C the NHWC planes (4, N·H·W, C) — for an int8 tensor just x
    itself as its one plane, with no pre-pass; else (``patch``) the
    im2col patch matrix's planes (4, N·H·W, Mp), K²C padded to 64 columns,
    which the GEMM reads as a 1×1 conv.
    """
    n, h, w_sp, c = x.shape
    if c % 16 == 0:
        if x.dtype == torch.int8:
            return x.reshape(1, n * h * w_sp, c), 1, False
        v = x.to(INT_DTYPE).reshape(n * h * w_sp, c)
        return s8_digits(v), digits_needed(v), False
    k = kernel_size
    patches = im2col(x.to(INT_DTYPE), k, k // 2).reshape(n * h * w_sp, k * k * c)
    return s8_digits(_pad_cols(patches)), digits_needed(patches), True


def w_digit_planes(w: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The w pre-pass: w (K,K,C,F) as (K²C, F), transposed to four digit
    planes (4, F, Mp), and the digits it needs."""
    k, _, c, f = w.shape
    flat = w.to(INT_DTYPE).reshape(k * k * c, f)
    return padded_planes(flat.T, N_DIGITS), digits_needed(flat)


def conv_digit_rows(n: int, h: int, w_sp: int, *, pool: bool) -> torch.Tensor:
    """The GEMM's row order, as flat pixel indices: every pixel in order,
    or with the pool each 2×2 window's four pixels (dy, dx) in window
    order (n, h/2, w/2) — the pixels an odd H or W crops have no row."""
    idx = torch.arange(n * h * w_sp)
    if not pool:
        return idx
    return window_view_2x2(idx.reshape(n, h, w_sp, 1)).reshape(-1)


def digit_conv(x: torch.Tensor, w: torch.Tensor, *, pool: bool = False,
               w_planes: tuple[torch.Tensor, int] | None = None) -> torch.Tensor:
    """The forward conv GEMM: z (R, F) int32, R rows in
    ``conv_digit_rows`` order, as Σ_{i+j ≤ 3, i < nx, j < nw}
    2^(8(i+j)) · A_i · B_jᵀ (mod 2^32) over the x and w digit planes
    (``w_digit_planes(w)``, or ``w_planes`` when a pre-pass of its own
    wrote them).

    The contraction runs in slices of at most 16,384 columns; within a
    slice each shift's s32 sum (≤ 4 pairs of s8 products) stays below
    2^31, which is checked, and the slices combine mod 2^32.
    """
    n, h, w_sp, c = x.shape
    k, f = w.shape[0], w.shape[-1]
    xa, nx, patch = x_digit_planes(x, k)
    wb, nw = w_digit_planes(w) if w_planes is None else w_planes
    rows = conv_digit_rows(n, h, w_sp, pool=pool)
    if patch:  # a 1×1 conv over the patch planes
        a = xa[:nx][:, rows]
    else:  # implicit im2col of each plane, zero halo
        planes = xa[:nx].reshape(nx * n, h, w_sp, c)
        a = im2col(planes, k, k // 2).reshape(nx, n * h * w_sp, k * k * c)
        a = _pad_cols(a)[:, rows]
    total = torch.zeros((len(rows), f), dtype=torch.int64)
    for c0 in range(0, a.shape[-1], FOLD_COLS):
        sets = [torch.zeros((len(rows), f), dtype=torch.int64) for _ in range(N_DIGITS)]
        for i in range(nx):
            for j in range(nw):
                if i + j < N_DIGITS:
                    sets[i + j] += (a[i, :, c0:c0 + FOLD_COLS].to(torch.int64)
                                    @ wb[j, :, c0:c0 + FOLD_COLS].to(torch.int64).T)
        for s, acc in enumerate(sets):
            if acc.numel() and int(acc.abs().max()) >= 2 ** 31:
                raise AssertionError(f"shift {s}: s32 digit sum {int(acc.abs().max())}")
            total += acc << (8 * s)
    return (((total + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(INT_DTYPE)


def stream_conv_digits(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    pool: bool = False,
    out_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """``stream_conv_ref`` computed as the CUDA kernel computes it: the
    digit GEMM, scale (+ReLU) on each row, then the max over each window's
    four rows → (N,H,W,F) or (N,H//2,W//2,F) in ``out_dtype``."""
    n, h, w_sp, _ = x.shape
    f = w.shape[-1]
    a = scale_forward(digit_conv(x, w, pool=pool), sf)
    if apply_relu:
        a = nitro_relu(a, alpha_inv)
    if pool:
        return a.reshape(n, h // 2, w_sp // 2, 4, f).amax(dim=3).to(out_dtype)
    return a.reshape(n, h, w_sp, f).to(out_dtype)


def stream_conv_fwd_digits(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``stream_conv_fwd_ref`` computed as the CUDA kernel computes it:
    ``(a, z*)``, both int32 (N,H,W,F)."""
    n, h, w_sp, _ = x.shape
    z_star = scale_forward(digit_conv(x, w), sf).reshape(n, h, w_sp, w.shape[-1])
    return nitro_relu(z_star, alpha_inv), z_star


# ---------------------------------------------------------------------------
# The conv input-gradient kernel's arithmetic (csrc/stream_conv_grad_x.cu,
# on conv_digits.cuh's GEMM): the masked δ's digit planes, the rotated
# weight's planes read from w as it lies, then the forward conv's digit
# GEMM at unit scale.  Bitwise the same function as stream_conv_grad_x_ref.
# ---------------------------------------------------------------------------

def rot_w_digit_planes(w: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The rotated-weight pre-pass: w (K,K,C,F) read as it lies, row c of
    the four digit planes (4, C, K²F padded to 64) being, segment by
    segment, the run w[K²−1−seg, c, :] — the planes ``w_digit_planes``
    gives for ``rot180_swap(w)``, with no rotated copy — and the digits w
    needs."""
    k, _, c, f = w.shape
    rows = w.to(INT_DTYPE).reshape(k * k, c, f).flip(0).permute(1, 0, 2).reshape(c, k * k * f)
    return padded_planes(rows, N_DIGITS), digits_needed(rows)


def stream_conv_grad_x_digits(
    grad_out: torch.Tensor,
    w: torch.Tensor,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """``stream_conv_grad_x_ref`` computed as the CUDA kernel computes it:
    δ masked by the NITRO-ReLU derivative as its digit planes are written
    (``x_digit_planes``: NHWC for 16 | F, else the patch planes), the
    rotated weight's planes (``rot_w_digit_planes``), then ``digit_conv``'s
    GEMM, only the digit pairs the two counts allow, folded every 16,384
    columns → (N,H,W,C) int32."""
    g = grad_out.to(INT_DTYPE)
    if z_star is not None:
        g = nitro_relu_backward(z_star, g, alpha_inv)
    n, h, w_sp, _ = g.shape
    z = digit_conv(g, rot180_swap(w), w_planes=rot_w_digit_planes(w))
    return z.reshape(n, h, w_sp, w.shape[2])
