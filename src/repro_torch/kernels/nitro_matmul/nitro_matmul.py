"""Python wrappers of the hand-written NITRO matmul CUDA kernels.

  * ``nitro_matmul`` replaces the Pallas ``nitro_matmul``
    (``_nitro_matmul_kernel``): ``relu(⌊x @ w / SF⌋) − μ`` (or the scale
    alone) into int8 or int32 — the inference step;
  * ``nitro_matmul_fwd`` replaces ``nitro_matmul_fwd``
    (``_nitro_matmul_fwd_kernel``): ``(a, z*)`` from one accumulator — the
    training forward;
  * ``nitro_matmul_grad_w`` replaces ``nitro_matmul_grad_w``
    (``_nitro_grad_w_kernel``): ``xᵀ @ relu_bwd(z*, δ)`` — the training
    weight gradient;
  * ``nitro_matmul_grad_w_opt`` replaces ``nitro_matmul_grad_w_opt``
    (``_nitro_grad_w_opt_kernel``): that gradient with IntegerSGD in the
    flush, returning W′ — the ``fuse_opt`` weight update;
  * ``nitro_matmul_grad_x`` replaces ``nitro_matmul_grad_x``
    (``_nitro_grad_x_kernel``): ``relu_bwd(z*, δ) @ wᵀ`` with w read in
    its natural layout — the training input gradient.

Sources: ``csrc/nitro_matmul.cu`` (the first two: a split-K GEMM on the
int8 tensor cores over exact base-256 digits),
``csrc/nitro_matmul_grad_w.cu`` and ``csrc/nitro_matmul_grad_w_opt.cu``
(a shallow GEMM on the int8 tensor cores over exact digits,
``csrc_common/linear_grad_w.cuh``) and ``csrc/nitro_matmul_grad_x.cu``
(a split-K GEMM on the int8 tensor cores over exact digits, w split as
it is staged), which note each kernel's bound and design.  The wrappers
take CUDA tensors only; the dispatchers in ``ops.py`` send CPU tensors to
the plain versions in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.activations import mu_int8
from repro_torch.core.scaling import pow2_split
from repro_torch.kernels import cuda_lib
from repro_torch.obs import trace


def _digit_operand(t: torch.Tensor) -> torch.Tensor:
    """x or w as the digit kernels read them: int8 or int32 as they are
    (int16 lifted to int32), contiguous."""
    if t.dtype == torch.int16:
        t = t.to(torch.int32)
    return t.contiguous()


def _digit_call(name: str, x: torch.Tensor, w: torch.Tensor, outs, *args) -> None:
    """Launch ``name`` (``csrc/nitro_matmul.cu``'s split-K digit GEMM) on x
    (M,K) and w (K,N), int8 or int32 each, into ``outs``; ``args`` are the
    entry point's ints between K and the dtype flags."""
    m, k = x.shape
    n = w.shape[1]
    if -(-m // cuda_lib.GEMM_TILE) > 65535:  # one block row per 64 batch rows
        raise ValueError(f"{name}: batch exceeds the kernel's grid")
    x_int8, w_int8 = int(x.dtype == torch.int8), int(w.dtype == torch.int8)
    # an int8 x whose rows start 16-byte aligned is read as it is
    x_direct = int(bool(x_int8) and k % 16 == 0 and x.data_ptr() % 16 == 0)
    lib, launch = cuda_lib.entry("nitro_matmul", f"{name}_launch", 4 + len(outs),
                                 7 + len(args))
    sms = cuda_lib.sm_count(x.device)
    scratch = _scratch(lib, x.device, m, n, k, x_int8, w_int8, x_direct, sms)
    _, arrivals = cuda_lib.split_workspace(x.device, m, n)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            x.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in outs), scratch.data_ptr(),
            arrivals.data_ptr(), m, n, k, *args, x_int8, w_int8, x_direct, sms, stream,
        )
    cuda_lib.check(lib, err, name)


def _scratch(lib: ctypes.CDLL, device: torch.device, *shape: int) -> torch.Tensor:
    """The call's scratch (the digit flags, w's tile map and digit planes,
    x's digit planes, the splits' slots), sized by the library; its
    contents need no zeroing (the GEMM reads only bytes the call writes)."""
    fn = lib.nitro_matmul_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(shape)
        fn.restype = ctypes.c_longlong
    return torch.empty(fn(*shape), dtype=torch.uint8, device=device)


@trace.spanned("kernel.nitro_matmul")
def nitro_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    out_dtype: torch.dtype = torch.int32,
    operand_dtype: str = "int32",
) -> torch.Tensor:
    """Fused ``nitro_relu(⌊(x @ w)/sf⌋)`` on the card: x (M,K), w (K,N).

    ``operand_dtype='int8'`` requires int8 operands; ``'int32'`` takes
    int8/int16/int32.  Both give the same result: the kernel reads int8
    and int32 operands as they are and runs a split-K GEMM on the int8
    tensor cores over exact signed base-256 digits (``csrc/nitro_matmul.cu``;
    the plain model is ``ref.nitro_matmul_digits``), only as many products
    as the data needs, decided on the card: one for int8 x and w.  A memset
    and at most three device launches per call.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes x{tuple(x.shape)} @ w{tuple(w.shape)}")
    x, w, alpha_inv = cuda_lib.check_inputs(
        "nitro_matmul", x, w, operand_dtype=operand_dtype, out_dtype=out_dtype,
        apply_relu=apply_relu, alpha_inv=alpha_inv, lift=False)
    m, k = x.shape
    n = w.shape[1]
    if max(m, n, k) >= 2 ** 31 or m * n >= 2 ** 31:
        raise ValueError("dimensions must fit int32")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    shift, residual = pow2_split(sf)
    _digit_call("nitro_matmul", _digit_operand(x), _digit_operand(w), (out,),
                shift, residual, alpha_inv, mu_int8(alpha_inv) if apply_relu else 0,
                int(apply_relu), int(out_dtype == torch.int8))
    nitro_matmul.launches.add()
    return out


#: launches of the CUDA kernel (the wrapper adds one per launch)
nitro_matmul.launches = cuda_lib.LaunchCounter()


def _check_2d(name: str, a: torch.Tensor, b: torch.Tensor, dim_a: int, dim_b: int):
    if a.ndim != 2 or b.ndim != 2 or a.shape[dim_a] != b.shape[dim_b]:
        raise ValueError(f"{name}: bad shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if max(*a.shape, *b.shape) >= 2 ** 31 or a.numel() >= 2 ** 31 or b.numel() >= 2 ** 31:
        raise ValueError(f"{name}: dimensions must fit int32")


@trace.spanned("kernel.nitro_matmul_fwd")
def nitro_matmul_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused training forward on the card: ``(a, z_star)``, both int32.

    x (M,K) and w (K,N), integer; ``z_star = ⌊x @ w / sf⌋``,
    ``a = nitro_relu(z_star)``.  The products run as in ``nitro_matmul``
    (the plain model is ``ref.nitro_matmul_fwd_digits``); a memset and at
    most three device launches per call.
    """
    _check_2d("nitro_matmul_fwd", x, w, 1, 0)
    cuda_lib.require_cuda("nitro_matmul_fwd", x, w)
    if alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    for t in (x, w):
        if t.dtype not in (torch.int8, torch.int16, torch.int32):
            raise ValueError(f"nitro_matmul_fwd: integer operands expected, got {t.dtype}")
    m, n = x.shape[0], w.shape[1]
    if m * n >= 2 ** 31:
        raise ValueError("nitro_matmul_fwd: dimensions must fit int32")
    a = torch.empty((m, n), dtype=torch.int32, device=x.device)
    z_star = torch.empty_like(a)
    if a.numel() == 0:
        return a, z_star
    shift, residual = pow2_split(sf)
    _digit_call("nitro_matmul_fwd", _digit_operand(x), _digit_operand(w), (a, z_star),
                shift, residual, int(alpha_inv), mu_int8(alpha_inv))
    nitro_matmul_fwd.launches.add()
    return a, z_star


@trace.spanned("kernel.nitro_matmul_grad_w")
def nitro_matmul_grad_w(
    x: torch.Tensor,
    delta: torch.Tensor,
    z_star: torch.Tensor,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Fused weight gradient on the card: ``xᵀ @ relu_bwd(z_star, δ)``.

    x (B,M), delta and z_star (B,N) → (M,N) int32.  One device launch: a
    shallow GEMM on the int8 tensor cores over exact signed base-256
    digits (``csrc_common/linear_grad_w.cuh``; the plain model is
    ``ref.grad_w_digits``), each block splitting its slabs of x and
    masked δ into digits as it stages them, running only the digit pairs
    its tile needs (decided on the card) and storing its tile once: no
    zero-fill, no atomics.
    """
    _check_2d("nitro_matmul_grad_w", x, delta, 0, 0)
    if z_star.shape != delta.shape:
        raise ValueError(f"delta/z_star shape mismatch {tuple(delta.shape)} "
                         f"vs {tuple(z_star.shape)}")
    cuda_lib.require_cuda("nitro_matmul_grad_w", x, delta, z_star)
    if alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    x, delta, z_star = cuda_lib.as_int32("nitro_matmul_grad_w", x, delta, z_star)
    b, m = x.shape
    n = delta.shape[1]
    _check_grid("nitro_matmul_grad_w", m, n)
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib, launch = cuda_lib.entry("nitro_matmul_grad_w", "nitro_matmul_grad_w_launch", 4, 5)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), delta.data_ptr(), z_star.data_ptr(), out.data_ptr(),
                     b, m, n, alpha_inv, cuda_lib.sm_count(x.device), stream)
    cuda_lib.check(lib, err, "nitro_matmul_grad_w")
    nitro_matmul_grad_w.launches.add()
    return out


def _check_grid(name: str, m: int, n: int) -> None:
    """The grad_W kernels' grid: one block per 128 × 64 output tile."""
    if m * n >= 2 ** 31 or -(-m // cuda_lib.DIGIT_TILE[0]) > 65535:
        raise ValueError(f"{name}: output ({m}, {n}) exceeds the kernel's grid")


@trace.spanned("kernel.nitro_matmul_grad_w_opt")
def nitro_matmul_grad_w_opt(
    x: torch.Tensor,
    delta: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    gamma_inv,
    eta_inv,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Fused weight update on the card: ``W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋)``
    with ``g = xᵀ @ relu_bwd(z_star, δ)``, which is never written.

    x (B,M), delta and z_star (B,N), w (M,N) → W′ (M,N) int32.
    ``gamma_inv``/``eta_inv`` are the optimiser state's 0-d int32 tensors
    on the card (the kernel reads them there: no host sync) or ints.  One
    device launch: ``nitro_matmul_grad_w``'s GEMM (the plain model is
    ``ref.grad_w_opt_digits``), IntegerSGD applied from its registers,
    with no workspace or arrival counter at any batch depth.
    """
    _check_2d("nitro_matmul_grad_w_opt", x, delta, 0, 0)
    if z_star.shape != delta.shape:
        raise ValueError(f"delta/z_star shape mismatch {tuple(delta.shape)} "
                         f"vs {tuple(z_star.shape)}")
    if w.shape != (x.shape[1], delta.shape[1]):
        raise ValueError(f"nitro_matmul_grad_w_opt: w {tuple(w.shape)} != "
                         f"({x.shape[1]}, {delta.shape[1]})")
    cuda_lib.require_cuda("nitro_matmul_grad_w_opt", x, delta, z_star, w)
    if alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    x, delta, z_star, w = cuda_lib.as_int32(
        "nitro_matmul_grad_w_opt", x, delta, z_star, w)
    gamma = cuda_lib.sgd_scalar("gamma_inv", gamma_inv, x.device)
    eta = cuda_lib.sgd_scalar("eta_inv", eta_inv, x.device)
    b, m = x.shape
    n = delta.shape[1]
    _check_grid("nitro_matmul_grad_w_opt", m, n)
    w_new = torch.empty_like(w)
    if w.numel() == 0:
        return w_new
    lib, launch = cuda_lib.entry(
        "nitro_matmul_grad_w_opt", "nitro_matmul_grad_w_opt_launch", 7, 5)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            x.data_ptr(), delta.data_ptr(), z_star.data_ptr(), w.data_ptr(),
            w_new.data_ptr(), gamma.data_ptr(), eta.data_ptr(), b, m, n, alpha_inv,
            cuda_lib.sm_count(x.device), stream,
        )
    cuda_lib.check(lib, err, "nitro_matmul_grad_w_opt")
    nitro_matmul_grad_w_opt.launches.add()
    return w_new


@trace.spanned("kernel.nitro_matmul_grad_x")
def nitro_matmul_grad_x(
    delta: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Fused input gradient on the card: ``relu_bwd(z_star, δ) @ wᵀ``.

    delta and z_star (B,N), w (M,N) as it lies (no transposed copy) →
    (B,M) int32.  A pre-pass masks δ and writes its digit planes; the
    split-K GEMM reads w once and splits it into digits as it builds its
    fragments, on the int8 tensor cores over exact signed base-256 digits
    (``csrc/nitro_matmul_grad_x.cu``; the plain model is
    ``ref.nitro_matmul_grad_x_digits``), only the digit pairs the data
    needs, decided on the card; the splits' tiles are summed by the last
    to arrive.  A memset and two device launches per call.
    """
    _check_2d("nitro_matmul_grad_x", delta, w, 1, 1)
    if z_star.shape != delta.shape:
        raise ValueError(f"delta/z_star shape mismatch {tuple(delta.shape)} "
                         f"vs {tuple(z_star.shape)}")
    cuda_lib.require_cuda("nitro_matmul_grad_x", delta, z_star, w)
    if alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    delta, z_star, w = cuda_lib.as_int32("nitro_matmul_grad_x", delta, z_star, w)
    b, n = delta.shape
    m = w.shape[0]
    if -(-b // cuda_lib.GEMM_TILE) > 65535 or b * m >= 2 ** 31:
        raise ValueError("nitro_matmul_grad_x: batch exceeds the kernel's grid")
    out = torch.empty((b, m), dtype=torch.int32, device=delta.device)
    if out.numel() == 0:
        return out
    lib, launch = cuda_lib.entry("nitro_matmul_grad_x", "nitro_matmul_grad_x_launch", 6, 6)
    sms = cuda_lib.sm_count(delta.device)
    fn = lib.nitro_matmul_grad_x_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    scratch = torch.empty(fn(b, m, n, sms), dtype=torch.uint8, device=delta.device)
    _, arrivals = cuda_lib.split_workspace(delta.device, b, m)
    w_vec = int(n % 4 == 0 and w.data_ptr() % 16 == 0)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            delta.data_ptr(), z_star.data_ptr(), w.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), arrivals.data_ptr(), b, m, n, alpha_inv, w_vec, sms, stream,
        )
    cuda_lib.check(lib, err, "nitro_matmul_grad_x")
    nitro_matmul_grad_x.launches.add()
    return out


nitro_matmul_fwd.launches = cuda_lib.LaunchCounter()
nitro_matmul_grad_w.launches = cuda_lib.LaunchCounter()
nitro_matmul_grad_w_opt.launches = cuda_lib.LaunchCounter()
nitro_matmul_grad_x.launches = cuda_lib.LaunchCounter()
