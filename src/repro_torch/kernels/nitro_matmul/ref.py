"""Plain PyTorch versions of the NITRO matmul kernels (port of
``repro.kernels.nitro_matmul.ref``).

Composes integer matmul → NITRO Scaling → NITRO-ReLU (forward),
NITRO-ReLU derivative → integer matmul (weight and input gradients) and
the weight gradient → IntegerSGD (weight update) exactly as
``repro_torch.core`` defines them.  The CUDA kernels must match them bit
for bit; the CPU path of the dispatchers runs them.  Last, plain models
of the kernels' arithmetic on the card, exact int8 digit products: the
forward matmuls' split-K (``matmul_w_planes`` to
``nitro_matmul_fwd_digits``), the weight gradients' shallow tiles
(``tile_digits`` to ``grad_w_opt_digits``) and the input gradient's
split-K with w split as staged (``grad_x_w_planes``,
``nitro_matmul_grad_x_digits``).
"""

from __future__ import annotations

import torch

from repro_torch.core.activations import nitro_relu, nitro_relu_backward
from repro_torch.core.numerics import INT_DTYPE, int_matmul
from repro_torch.core.scaling import scale_backward, scale_forward
from repro_torch.kernels.digit_planes import N_DIGITS, digits_needed, padded_planes, s8_digits
from repro_torch.kernels.integer_sgd.ref import integer_sgd_ref


def nitro_matmul_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    out_dtype: torch.dtype = torch.int32,
    operand_dtype: str = "int32",
) -> torch.Tensor:
    """``relu(⌊(x @ w)/sf⌋) − μ`` (or the scale alone) for 2-D ``x``, ``w``.

    ``operand_dtype='int8'`` only checks that both operands are int8: the
    product is lifted to int32 either way (``int_matmul``), which is
    exactly the int8×int8→int32 accumulation.
    """
    if operand_dtype == "int8" and not (
        x.dtype == torch.int8 and w.dtype == torch.int8
    ):
        raise ValueError(
            f"operand_dtype='int8' requires int8 operands, got "
            f"{x.dtype}/{w.dtype}"
        )
    z_star = scale_forward(int_matmul(x, w), sf)
    if apply_relu:
        z_star = nitro_relu(z_star, alpha_inv)
    return z_star.to(out_dtype)


def nitro_matmul_fwd_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    out_dtype: torch.dtype = torch.int32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: ``(a, z_star)``; ``z_star`` is always int32 (the
    cache the NITRO-ReLU/STE backward reads)."""
    z_star = scale_forward(int_matmul(x, w), sf)
    return nitro_relu(z_star, alpha_inv).to(out_dtype), z_star


def masked_delta(delta: torch.Tensor, z_star: torch.Tensor,
                 alpha_inv: int) -> torch.Tensor:
    """The δ prologue the grad kernels apply on load: NITRO-ReLU
    derivative, then the scaling STE (the identity)."""
    return scale_backward(nitro_relu_backward(z_star, delta, alpha_inv))


def nitro_matmul_grad_w_ref(
    x: torch.Tensor,
    delta: torch.Tensor,
    z_star: torch.Tensor,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Weight gradient ``xᵀ @ relu_bwd(z*, δ)``: x (B,M), δ/z* (B,N) →
    (M,N) int32."""
    g = masked_delta(delta.to(INT_DTYPE), z_star, alpha_inv)
    return int_matmul(x.to(INT_DTYPE).T, g)


def nitro_matmul_grad_w_opt_ref(
    x: torch.Tensor,
    delta: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    gamma_inv,
    eta_inv,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Weight update: ``nitro_matmul_grad_w_ref`` then IntegerSGD → W′
    (M,N) int32."""
    grad_w = nitro_matmul_grad_w_ref(x, delta, z_star, alpha_inv=alpha_inv)
    return integer_sgd_ref(w, grad_w, gamma_inv, eta_inv)


def nitro_matmul_grad_x_ref(
    delta: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Input gradient ``relu_bwd(z*, δ) @ wᵀ``: δ/z* (B,N), w (M,N) in its
    natural layout → (B,M) int32."""
    g = masked_delta(delta.to(INT_DTYPE), z_star, alpha_inv)
    return int_matmul(g, w.to(INT_DTYPE).T)


# ---------------------------------------------------------------------------
# The forward matmul kernels' arithmetic (csrc/nitro_matmul.cu): x and w as
# int8 digit planes laid out K-contiguous, only the digit products the data
# needs, the contraction split across blocks whose s32 sums stay exact, the
# splits' tiles added mod 2^32, the epilogue on the whole sum.  Bitwise the
# same functions as nitro_matmul_ref and nitro_matmul_fwd_ref.
# ---------------------------------------------------------------------------

#: The digit GEMM's output tile (64 columns n × 64 batch rows m), its stage
#: (K is padded to a multiple) and the deepest split it sums in s32.
MATMUL_TILE = 64
STAGE = 64
MAX_SPLIT = 16384
#: Blocks the splits are planned for: one on each of an H100's 132 SMs.
H100_SLOTS = 132


def matmul_w_planes(w: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The w pre-pass: w (K, N) transposed to K-contiguous digit planes
    (planes, N, Kp), K zero-padded to 64 — one plane for an int8 w, else
    four — and the digits w needs."""
    planes = padded_planes(w.to(INT_DTYPE).T, 1 if w.dtype == torch.int8 else N_DIGITS)
    return planes, digits_needed(w)


def matmul_x_planes(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The x pre-pass: x (M, K) as digit planes (planes, M, Kp) — an int8 x
    is its own one plane (the kernel reads it as it is when 16 | K, the
    zero columns past K coming from its zero-filled copies) — and the
    digits x needs."""
    planes = padded_planes(x.to(INT_DTYPE), 1 if x.dtype == torch.int8 else N_DIGITS)
    return planes, digits_needed(x)


def plan_splits(tiles: int, kp: int, slots: int = H100_SLOTS, epi: int = 8,
                min_per: int = 1, tail: int = 1) -> tuple[int, int]:
    """``digit_gemm.cuh``'s ``plan_splits`` as the matmul kernels call it:
    ``(splits, columns a split)`` for a contraction ``kp`` deep over
    ``tiles`` output tiles and ``slots`` resident blocks — the count with
    the least estimated time in stages, waves × (stages a split + epi) +
    tail × (splits − 1), each split at least ``min_per`` stages and at
    most 16,384 columns deep, the fewest on a tie."""
    stages = kp // STAGE
    if stages == 0:
        return 1, STAGE
    least = -(-kp // MAX_SPLIT)
    most = min(max(stages // min_per, least), 65535)
    want, best = least, -1
    for s in range(least, most + 1):
        per = -(-stages // s)
        if -(-stages // per) != s:
            continue
        est = -(-tiles * s // slots) * (per + (epi if s > 1 else 0)) + tail * (s - 1)
        if best < 0 or est < best:
            best, want = est, s
    chunk = -(-stages // want) * STAGE
    return -(-kp // chunk), chunk


def digit_matmul(x: torch.Tensor, w: torch.Tensor, *, slots: int = H100_SLOTS) -> torch.Tensor:
    """The split-K digit GEMM: z (M, N) int32 = Σ over splits of
    Σ_{i+j ≤ 3, i < nx, j < nw} 2^(8(i+j)) · X_i · W_jᵀ (mod 2^32).

    Each split's s32 sums (at most four pairs of s8 products over at most
    16,384 columns) stay below 2^31, which is checked; a split's tile
    combines mod 2^32 and the splits add mod 2^32, as the kernel's
    atomics do, in any order.
    """
    m, n = x.shape[0], w.shape[1]
    xb, nx = matmul_x_planes(x)
    wb, nw = matmul_w_planes(w)
    kp = wb.shape[-1]
    tiles = -(-n // MATMUL_TILE) * -(-m // MATMUL_TILE)
    splits, chunk = plan_splits(tiles, kp, slots)
    total = torch.zeros((m, n), dtype=torch.int64)
    for s in range(splits):
        cols = slice(s * chunk, min(kp, (s + 1) * chunk))
        part = torch.zeros((m, n), dtype=torch.int64)
        for shift in range(N_DIGITS):
            acc = torch.zeros((m, n), dtype=torch.int64)
            for i in range(nx):
                j = shift - i
                if 0 <= j < nw:
                    acc += xb[i, :, cols].to(torch.int64) @ wb[j, :, cols].to(torch.int64).T
            if acc.numel() and int(acc.abs().max()) >= 2 ** 31:
                raise AssertionError(f"split {s} shift {shift}: s32 sum {int(acc.abs().max())}")
            part += acc << (8 * shift)
        total += part & 0xFFFFFFFF
    return (((total + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(INT_DTYPE)


def nitro_matmul_digits(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    out_dtype: torch.dtype = torch.int32,
    slots: int = H100_SLOTS,
) -> torch.Tensor:
    """``nitro_matmul_ref`` computed as the CUDA kernel computes it: the
    split-K digit GEMM, then scale (+ReLU) on the whole sum."""
    z = scale_forward(digit_matmul(x, w, slots=slots), sf)
    if apply_relu:
        z = nitro_relu(z, alpha_inv)
    return z.to(out_dtype)


def nitro_matmul_fwd_digits(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    slots: int = H100_SLOTS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``nitro_matmul_fwd_ref`` computed as the CUDA kernel computes it:
    ``(a, z*)``, both int32."""
    z_star = scale_forward(digit_matmul(x, w, slots=slots), sf)
    return nitro_relu(z_star, alpha_inv), z_star


# ---------------------------------------------------------------------------
# The weight-gradient kernels' arithmetic (csrc_common/linear_grad_w.cuh): one
# block per 128 × 64 tile of grad_W, the batch in chunks of 64 samples, each
# chunk's x and masked δ split into digits, only the digit pairs the tile's
# own digit counts allow, the pairs of one shift summed in one s32 set that
# is folded into the total mod 2^32 after every chunk.  Bitwise the same
# functions as nitro_matmul_grad_w_ref and nitro_matmul_grad_w_opt_ref.
# ---------------------------------------------------------------------------

#: The grad_W GEMM's output tile (rows m of x's columns, columns n of δ's)
#: and the samples it stages and folds at a time.
GRAD_W_TILE = (128, 64)
GRAD_W_CHUNK = 64


def tile_digits(planes: torch.Tensor, tile: int) -> torch.Tensor:
    """What a block's digit count gives each column: ``planes`` (4, P, R)
    are the digits of P samples of R columns; a column gets its tile's
    count (``tile`` columns a tile), 1 + the highest plane with a nonzero
    digit anywhere in the tile (1 when every digit is 0)."""
    _, _, r = planes.shape
    tiles = -(-r // tile)
    nonzero = torch.zeros((N_DIGITS, tiles * tile), dtype=torch.bool)
    nonzero[:, :r] = planes.ne(0).any(dim=1)
    nonzero = nonzero.view(N_DIGITS, tiles, tile).any(dim=2)
    rank = torch.arange(1, N_DIGITS + 1).view(-1, 1)
    need = (nonzero * rank).amax(dim=0).clamp(min=1)
    return need.repeat_interleave(tile)[:r]


def grad_w_digits(x: torch.Tensor, delta: torch.Tensor, z_star: torch.Tensor, *,
                  alpha_inv: int = 10) -> torch.Tensor:
    """``nitro_matmul_grad_w_ref`` computed as the CUDA kernel computes it:
    (M, N) int32 = Σ over chunks of Σ_s 2^(8s) · Σ_{i+j=s, i < nx, j < nd}
    X_iᵀ · G_j (mod 2^32), nx and nd the tile's digit counts in the chunk.

    Each shift's set (at most four pairs over 64 samples) stays below 2^31,
    which is checked; the digit products are exact in float64 (|Σ| ≤ 2^22).
    """
    g = masked_delta(delta.to(INT_DTYPE), z_star, alpha_inv)
    xd, gd = s8_digits(x.to(INT_DTYPE)), s8_digits(g)  # (4, B, M), (4, B, N)
    b, m = x.shape
    n = g.shape[1]
    total = torch.zeros((m, n), dtype=torch.int64)
    for p0 in range(0, b, GRAD_W_CHUNK):
        xs, gs = xd[:, p0:p0 + GRAD_W_CHUNK], gd[:, p0:p0 + GRAD_W_CHUNK]
        nx, nd = tile_digits(xs, GRAD_W_TILE[0]), tile_digits(gs, GRAD_W_TILE[1])
        xs, gs = xs.to(torch.float64), gs.to(torch.float64)
        for shift in range(N_DIGITS):
            acc = torch.zeros((m, n), dtype=torch.float64)
            for i in range(shift + 1):
                use = (nx > i)[:, None] & (nd > shift - i)[None, :]
                if bool(use.any()):
                    acc += (xs[i].T @ gs[shift - i]) * use
            if acc.numel() and float(acc.abs().max()) >= 2 ** 31:
                raise AssertionError(f"chunk at {p0} shift {shift}: s32 sum "
                                     f"{float(acc.abs().max())}")
            total += acc.to(torch.int64) << (8 * shift)
        total &= 0xFFFFFFFF
    return (((total + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(INT_DTYPE)


def grad_w_opt_digits(x: torch.Tensor, delta: torch.Tensor, z_star: torch.Tensor,
                      w: torch.Tensor, gamma_inv, eta_inv, *,
                      alpha_inv: int = 10) -> torch.Tensor:
    """``nitro_matmul_grad_w_opt_ref`` computed as the CUDA kernel computes
    it: ``grad_w_digits``' sums, then IntegerSGD on each whole sum → W′."""
    grad_w = grad_w_digits(x, delta, z_star, alpha_inv=alpha_inv)
    return integer_sgd_ref(w, grad_w, gamma_inv, eta_inv)


# ---------------------------------------------------------------------------
# The input-gradient kernel's arithmetic (csrc/nitro_matmul_grad_x.cu):
# grad_xᵀ = w · maskedδᵀ as a split-K GEMM, the masked δ's digit planes
# from a pre-pass, w split into digits as each warp stages it (its own
# digit count per 16 rows × 32-deep step), the splits' tiles added mod 2^32
# by the last to arrive.  Bitwise the same function as
# nitro_matmul_grad_x_ref.
# ---------------------------------------------------------------------------

#: What one warp's digit count of w covers: 16 rows by a 32-deep step.
GRAD_X_WARP = (16, 32)


def grad_x_w_planes(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w (M, N) split into digits as the GEMM stages it: the four planes
    (4, M, Np), N zero-padded to 64 — no pre-pass writes them, each warp
    forms its fragments' planes from the int32 values — and each column's
    count (M, Np): the digits its warp's 16 rows × 32-deep step needs, the
    products j ≥ count of which the warp skips."""
    planes = padded_planes(w.to(INT_DTYPE), N_DIGITS)
    rows, steps = GRAD_X_WARP
    m, np_ = planes.shape[1:]
    mp = -(-m // rows) * rows
    nonzero = torch.zeros((N_DIGITS, mp, np_), dtype=torch.bool)
    nonzero[:, :m] = planes.ne(0)
    nonzero = nonzero.view(N_DIGITS, mp // rows, rows, np_ // steps, steps).any(dim=(2, 4))
    rank = torch.arange(1, N_DIGITS + 1).view(-1, 1, 1)
    need = (nonzero * rank).amax(dim=0).clamp(min=1)
    need = need.repeat_interleave(rows, dim=0).repeat_interleave(steps, dim=1)[:m]
    return planes, need


def nitro_matmul_grad_x_digits(delta: torch.Tensor, z_star: torch.Tensor, w: torch.Tensor,
                               *, alpha_inv: int = 10, slots: int = H100_SLOTS
                               ) -> torch.Tensor:
    """``nitro_matmul_grad_x_ref`` computed as the CUDA kernel computes it:
    (B, M) int32 = Σ over splits of Σ_{i+j ≤ 3, i < nd, j < nw}
    2^(8(i+j)) · D_i · W_jᵀ (mod 2^32), D the masked δ's planes (nd its
    digit count), W w's (nw its warp's count at each column), the splits
    ``plan_splits`` makes for the 64 × 64 tiles of grad_xᵀ.

    Each split's s32 sums (at most four pairs of s8 products over at most
    16,384 columns) stay below 2^31, which is checked; the splits add mod
    2^32 in any order, as the last block to arrive adds their slots.
    """
    g = masked_delta(delta.to(INT_DTYPE), z_star, alpha_inv)
    db, nd = matmul_x_planes(g)
    wb, nw = grad_x_w_planes(w)
    b, m, np_ = g.shape[0], w.shape[0], wb.shape[-1]
    tiles = -(-m // MATMUL_TILE) * -(-b // MATMUL_TILE)
    splits, chunk = plan_splits(tiles, np_, slots)
    total = torch.zeros((b, m), dtype=torch.int64)
    for s in range(splits):
        cols = slice(s * chunk, min(np_, (s + 1) * chunk))
        part = torch.zeros((b, m), dtype=torch.int64)
        for shift in range(N_DIGITS):
            acc = torch.zeros((b, m), dtype=torch.int64)
            for i in range(nd):
                j = shift - i
                if 0 <= j < N_DIGITS:
                    wj = wb[j, :, cols].to(torch.int64) * (nw[:, cols] > j)
                    acc += db[i, :, cols].to(torch.int64) @ wj.T
            if acc.numel() and int(acc.abs().max()) >= 2 ** 31:
                raise AssertionError(f"split {s} shift {shift}: s32 sum {int(acc.abs().max())}")
            part += acc << (8 * shift)
        total += part & 0xFFFFFFFF
    return (((total + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(INT_DTYPE)
