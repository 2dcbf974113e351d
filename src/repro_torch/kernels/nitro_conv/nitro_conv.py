"""Python wrappers of the hand-written streaming conv CUDA kernels.

  * ``stream_conv`` replaces the Pallas ``stream_conv``
    (``_stream_conv_kernel``): a K×K stride-1 'same' NHWC conv by implicit
    im2col with the NITRO scale / ReLU epilogue and an optional fused 2×2
    max-pool — the inference step;
  * ``stream_conv_fwd`` replaces ``stream_conv_fwd``
    (``_stream_conv_fwd_kernel``): the conv writing ``(a, z*)`` — the
    training forward, an implicit-im2col GEMM over all N·H·W pixels;
    both forward convs run on the int8 tensor cores over exact signed
    base-256 digits of x and w;
  * ``stream_conv_grad_w`` replaces ``stream_conv_grad_w``
    (``_stream_grad_w_fused_kernel`` / ``_stream_grad_w_kernel``): the
    weight gradient, δ masked by the NITRO-ReLU derivative when z* is
    given, on the int8 tensor cores over exact signed base-256 digits;
  * ``stream_conv_grad_w_opt`` replaces ``stream_conv_grad_w_opt``
    (``_stream_grad_w_opt_kernel``): that gradient with IntegerSGD in the
    flush, returning W′ — the ``fuse_opt`` weight update;
  * ``stream_conv_grad_x`` replaces ``stream_conv_grad_x``
    (``_stream_grad_x_kernel``): the input gradient, the 'full'
    correlation of δ masked by the NITRO-ReLU derivative with
    ``rot180_swap(w)``, on the forward convs' digit GEMM over the masked
    δ's digits.

Sources: ``csrc/stream_conv.cu``, ``csrc/stream_conv_fwd.cu``,
``csrc/stream_conv_grad_w.cu``, ``csrc/stream_conv_grad_w_opt.cu`` and
``csrc/stream_conv_grad_x.cu``, which note each kernel's bound and
design.  The wrappers take CUDA tensors only; the dispatchers in
``ops.py`` send CPU tensors to the plain versions in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.activations import mu_int8
from repro_torch.core.scaling import pow2_split
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.nitro_conv.ref import DEFAULT_BH
from repro_torch.obs import trace


def _conv_shapes(name: str, x: torch.Tensor, k: int, c_w: int) -> None:
    if x.ndim != 4 or x.shape[3] != c_w or k % 2 == 0:
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)}, K={k}, C={c_w}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: input must have fewer than 2^31 elements")


def _digit_operand(t: torch.Tensor) -> torch.Tensor:
    """x or w as the forward conv digit kernels read it: int8 or int32 as
    it is (int16 lifted to int32), contiguous, 16-byte aligned."""
    if t.dtype == torch.int16:
        t = t.to(torch.int32)
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _forward_digit_call(name: str, x: torch.Tensor, w: torch.Tensor, outs, rows: int,
                        *args: int) -> None:
    """Launch the forward conv digit GEMM ``name`` (conv_digits.cuh) of
    ``rows`` GEMM rows: x (N,H,W,C) and w (K,K,C,F), int8 or int32 each,
    into ``outs``; ``args`` are the entry point's ints after the shapes and
    dtypes.  Raises on shapes beyond its grid (one block row per 128 GEMM
    rows) or outputs of 2^31 elements or more."""
    n, h, w_sp, c = x.shape
    k, f = w.shape[0], w.shape[-1]
    if -(-rows // cuda_lib.DIGIT_TILE[0]) > 65535 or outs[0].numel() >= 2 ** 31:
        raise ValueError(f"{name}: shape exceeds the kernel's grid")
    x, w = _digit_operand(x), _digit_operand(w)
    x_int8 = int(x.dtype == torch.int8)
    lib, launch = cuda_lib.entry(name, f"{name}_launch", 3 + len(outs), 9 + len(args))
    scratch = _digit_scratch(lib, name, x.device, n, h, w_sp, c, f, k, x_int8)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            x.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in outs), scratch.data_ptr(),
            n, h, w_sp, c, f, k, x_int8, int(w.dtype == torch.int8), *args,
            cuda_lib.sm_count(x.device), stream,
        )
    cuda_lib.check(lib, err, name)


@trace.spanned("kernel.stream_conv")
def stream_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
    apply_relu: bool = True,
    pool: bool = False,
    out_dtype: torch.dtype = torch.int32,
    bh: int = DEFAULT_BH,
    operand_dtype: str = "int32",
) -> torch.Tensor:
    """Streaming fused 'same' conv on the card: ``relu(⌊conv(x, w)/sf⌋)``
    (+2×2 pool).  x (N,H,W,C), w (K,K,C,F), K odd → (N,H,W,F), or
    (N,H//2,W//2,F) with ``pool=True`` (odd H or W cropped).

    ``operand_dtype='int8'`` requires int8 operands; ``'int32'`` takes
    int8/int16/int32.  The kernel reads int8 and int32 operands as they
    are, and runs on the int8 tensor cores over exact signed base-256
    digits (``conv_digits.cuh``; the plain model is
    ``ref.stream_conv_digits``), only as many products as the data needs,
    decided on the card: one for an int8 x and w.  ``bh`` (the plain
    version's band height) does not change the kernel.  A memset and at
    most three device launches per call.
    """
    if x.ndim != 4 or w.ndim != 4 or w.shape[0] != w.shape[1] or w.shape[2] != x.shape[3]:
        raise ValueError(f"bad shapes x{tuple(x.shape)} * w{tuple(w.shape)}")
    x, w, alpha_inv = cuda_lib.check_inputs(
        "stream_conv", x, w, operand_dtype=operand_dtype, out_dtype=out_dtype,
        apply_relu=apply_relu, alpha_inv=alpha_inv, lift=False)
    _conv_shapes("stream_conv", x, w.shape[0], w.shape[2])
    n, h, w_sp, _ = x.shape
    f = w.shape[-1]
    if pool and (h < 2 or w_sp < 2):
        raise ValueError(f"2x2 pool epilogue needs H,W >= 2, got {h}x{w_sp}")
    out_shape = (n, h // 2, w_sp // 2, f) if pool else (n, h, w_sp, f)
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    shift, residual = pow2_split(sf)
    rows = 4 * out.numel() // f if pool else out.numel() // f  # 4 per pool window
    _forward_digit_call(
        "stream_conv", x, w, (out,), rows, shift, residual, alpha_inv,
        mu_int8(alpha_inv) if apply_relu else 0, int(apply_relu), int(pool),
        int(out_dtype == torch.int8))
    stream_conv.launches.add()
    return out


#: launches of the CUDA kernel (the wrapper adds one per launch)
stream_conv.launches = cuda_lib.LaunchCounter()


@trace.spanned("kernel.stream_conv_fwd")
def stream_conv_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sf: int,
    alpha_inv: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming training forward on the card: ``(a, z_star)``, both int32
    (N,H,W,F).  x (N,H,W,C) and w (K,K,C,F), integer.

    The products run as in ``stream_conv`` (int8 digit products on the
    tensor cores, only those the data needs, decided on the card; the
    plain model is ``ref.stream_conv_fwd_digits``); a memset and at most
    three device launches per call.
    """
    if w.ndim != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"stream_conv_fwd: bad weight shape {tuple(w.shape)}")
    _conv_shapes("stream_conv_fwd", x, w.shape[0], w.shape[2])
    cuda_lib.require_cuda("stream_conv_fwd", x, w)
    if alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    for t in (x, w):
        if t.dtype not in (torch.int8, torch.int16, torch.int32):
            raise ValueError(f"stream_conv_fwd: integer operands expected, got {t.dtype}")
    n, h, w_sp, _ = x.shape
    a = torch.empty((n, h, w_sp, w.shape[-1]), dtype=torch.int32, device=x.device)
    z_star = torch.empty_like(a)
    if a.numel() == 0:
        return a, z_star
    shift, residual = pow2_split(sf)
    _forward_digit_call("stream_conv_fwd", x, w, (a, z_star), n * h * w_sp, shift,
                        residual, int(alpha_inv), mu_int8(alpha_inv))
    stream_conv_fwd.launches.add()
    return a, z_star


def _digit_limits(name: str, h: int, w_sp: int, m: int, f: int) -> None:
    """Raise on shapes the conv digit GEMM cannot take: its grid (one
    block row per 128 patch columns, one column per 64 filters) and the
    16-bit (h, w) it keeps per pixel."""
    bm, bn = cuda_lib.DIGIT_TILE
    if -(-m // bm) > 65535 or -(-f // bn) > 65535 or max(h, w_sp) >= 2 ** 15:
        raise ValueError(f"{name}: shape exceeds the kernel's grid")


def _digit_scratch(lib: ctypes.CDLL, name: str, device: torch.device,
                   *shape: int) -> torch.Tensor:
    """The call's scratch for a conv digit GEMM (flags and the operands'
    digit planes), sized by the library; its contents need no zeroing (the
    pre-passes write every byte the GEMM reads)."""
    fn = getattr(lib, f"{name}_scratch_bytes")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(shape)
        fn.restype = ctypes.c_longlong
    return torch.empty(fn(*shape), dtype=torch.uint8, device=device)


@trace.spanned("kernel.stream_conv_grad_w")
def stream_conv_grad_w(
    x: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    kernel_size: int,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Streaming conv weight gradient on the card: (N,H,W,C) input ×
    (N,H,W,F) grad → (K,K,C,F) int32.

    With ``z_star`` (the shape of ``grad_out``) each δ is masked by the
    NITRO-ReLU derivative as the kernel's pre-pass reads it; without it δ
    is taken as it is.  The products run on the int8 tensor cores over
    exact signed base-256 digits of x and δ (``digit_gemm.cuh``; the
    plain model is ``ref.stream_conv_grad_w_digits``), only as many as the
    data needs, decided on the card.  The contraction over N·H·W is split
    across blocks whose partial sums are added with atomics (exact: int32
    addition wraps mod 2³² in any order).  Four device launches per call
    (x's range, δ's digits, x's patch digits, the GEMM) after a memset.
    """
    k = int(kernel_size)
    _conv_shapes("stream_conv_grad_w", x, k, x.shape[-1] if x.ndim == 4 else -1)
    if grad_out.ndim != 4 or grad_out.shape[:3] != x.shape[:3]:
        raise ValueError(f"stream_conv_grad_w: grad {tuple(grad_out.shape)} "
                         f"does not match input {tuple(x.shape)}")
    if z_star is not None and z_star.shape != grad_out.shape:
        raise ValueError("delta/z_star shape mismatch")
    operands = (x, grad_out) if z_star is None else (x, grad_out, z_star)
    cuda_lib.require_cuda("stream_conv_grad_w", *operands)
    if z_star is not None and alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    operands = cuda_lib.as_int32("stream_conv_grad_w", *operands)
    x, grad_out = operands[0], operands[1]
    z_ptr = operands[2].data_ptr() if z_star is not None else None
    n, h, w_sp, c = x.shape
    f = grad_out.shape[-1]
    _digit_limits("stream_conv_grad_w", h, w_sp, k * k * c, f)
    out = torch.zeros((k * k * c, f), dtype=torch.int32, device=x.device)
    if out.numel() == 0 or n * h * w_sp == 0:
        return out.reshape(k, k, c, f)
    lib, launch = cuda_lib.entry("stream_conv_grad_w", "stream_conv_grad_w_launch", 5, 8)
    scratch = _digit_scratch(lib, "stream_conv_grad_w", x.device, n, h, w_sp, c, f, k)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            x.data_ptr(), grad_out.data_ptr(), z_ptr, out.data_ptr(),
            scratch.data_ptr(), n, h, w_sp, c, f, k, max(int(alpha_inv), 1),
            cuda_lib.sm_count(x.device), stream,
        )
    cuda_lib.check(lib, err, "stream_conv_grad_w")
    stream_conv_grad_w.launches.add()
    return out.reshape(k, k, c, f)


@trace.spanned("kernel.stream_conv_grad_w_opt")
def stream_conv_grad_w_opt(
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
    """Streaming conv weight update on the card: ``stream_conv_grad_w``'s
    gradient g with IntegerSGD in the flush, ``W − (⌊g/γ_inv⌋ +
    ⌊W/η_inv⌋)``; g is never written.

    x (N,H,W,C), grad_out and z_star (N,H,W,F), w (K,K,C,F) → W′ (K,K,C,F)
    int32.  ``gamma_inv``/``eta_inv`` are the optimiser state's 0-d int32
    tensors on the card (read there: no host sync) or ints.  The gradient
    runs as in ``stream_conv_grad_w`` (int8 digit products on the tensor
    cores; four device launches after a memset), its split sums meeting
    in the workspace shared with ``nitro_matmul_grad_w_opt``.
    """
    k = int(kernel_size)
    _conv_shapes("stream_conv_grad_w_opt", x, k, x.shape[-1] if x.ndim == 4 else -1)
    if grad_out.ndim != 4 or grad_out.shape[:3] != x.shape[:3]:
        raise ValueError(f"stream_conv_grad_w_opt: grad {tuple(grad_out.shape)} "
                         f"does not match input {tuple(x.shape)}")
    if z_star.shape != grad_out.shape:
        raise ValueError("delta/z_star shape mismatch")
    n, h, w_sp, c = x.shape
    f = grad_out.shape[-1]
    if tuple(w.shape) != (k, k, c, f):
        raise ValueError(f"stream_conv_grad_w_opt: w {tuple(w.shape)} != "
                         f"{(k, k, c, f)}")
    cuda_lib.require_cuda("stream_conv_grad_w_opt", x, grad_out, z_star, w)
    if alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    x, grad_out, z_star, w = cuda_lib.as_int32(
        "stream_conv_grad_w_opt", x, grad_out, z_star, w)
    gamma = cuda_lib.sgd_scalar("gamma_inv", gamma_inv, x.device)
    eta = cuda_lib.sgd_scalar("eta_inv", eta_inv, x.device)
    m = k * k * c
    _digit_limits("stream_conv_grad_w_opt", h, w_sp, m, f)
    w_new = torch.empty_like(w)
    if w.numel() == 0:
        return w_new
    lib, launch = cuda_lib.entry(
        "stream_conv_grad_w_opt", "stream_conv_grad_w_opt_launch", 10, 8)
    ws, arrivals = cuda_lib.split_workspace(x.device, m, f, cuda_lib.DIGIT_TILE)
    scratch = _digit_scratch(lib, "stream_conv_grad_w_opt", x.device, n, h, w_sp, c, f, k)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            x.data_ptr(), grad_out.data_ptr(), z_star.data_ptr(), w.data_ptr(),
            w_new.data_ptr(), gamma.data_ptr(), eta.data_ptr(), ws.data_ptr(),
            arrivals.data_ptr(), scratch.data_ptr(), n, h, w_sp, c, f, k,
            int(alpha_inv), cuda_lib.sm_count(x.device), stream,
        )
    cuda_lib.check(lib, err, "stream_conv_grad_w_opt")
    stream_conv_grad_w_opt.launches.add()
    return w_new


@trace.spanned("kernel.stream_conv_grad_x")
def stream_conv_grad_x(
    delta: torch.Tensor,
    z_star: torch.Tensor,
    w: torch.Tensor,
    *,
    alpha_inv: int = 10,
) -> torch.Tensor:
    """Streaming conv input gradient on the card: the 'full' correlation
    of ``relu_bwd(z_star, δ)`` with ``rot180_swap(w)``, unit scale, no
    activation.

    delta and z_star (N,H,W,F), w (K,K,C,F) → (N,H,W,C) int32.  A
    pre-pass masks δ and writes its digit planes (the masked δ is never
    written as int32), another writes the rotated weight's planes from w
    as it lies, and the products run on the int8 tensor cores over exact
    signed base-256 digits (``conv_digits.cuh``; the plain model is
    ``ref.stream_conv_grad_x_digits``), only as many as the data needs,
    decided on the card.  A memset and three device launches per call.
    """
    if w.ndim != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"stream_conv_grad_x: bad weight shape {tuple(w.shape)}")
    k, c, f = w.shape[0], w.shape[2], w.shape[3]
    _conv_shapes("stream_conv_grad_x", delta, k, f)
    if z_star.shape != delta.shape:
        raise ValueError("delta/z_star shape mismatch")
    cuda_lib.require_cuda("stream_conv_grad_x", delta, z_star, w)
    if alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    delta, z_star, w = cuda_lib.as_int32("stream_conv_grad_x", delta, z_star, w)
    delta, z_star = _digit_operand(delta), _digit_operand(z_star)  # 16-byte loads
    n, h, w_sp, _ = delta.shape
    out = torch.empty((n, h, w_sp, c), dtype=torch.int32, device=delta.device)
    if out.numel() == 0:
        return out
    if out.numel() >= 2 ** 31:
        raise ValueError("stream_conv_grad_x: output must have fewer than 2^31 elements")
    _digit_limits("stream_conv_grad_x", h, w_sp, n * h * w_sp, c)
    lib, launch = cuda_lib.entry("stream_conv_grad_x", "stream_conv_grad_x_launch", 5, 8)
    scratch = _digit_scratch(lib, "stream_conv_grad_x", delta.device, n, h, w_sp, f, c, k)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            delta.data_ptr(), z_star.data_ptr(), w.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, h, w_sp, f, c, k, int(alpha_inv),
            cuda_lib.sm_count(delta.device), stream,
        )
    cuda_lib.check(lib, err, "stream_conv_grad_x")
    stream_conv_grad_x.launches.add()
    return out


stream_conv_fwd.launches = cuda_lib.LaunchCounter()
stream_conv_grad_w.launches = cuda_lib.LaunchCounter()
stream_conv_grad_w_opt.launches = cuda_lib.LaunchCounter()
stream_conv_grad_x.launches = cuda_lib.LaunchCounter()
