"""Python wrapper of the hand-written exact integer matmul CUDA kernels.

``int_matmul_cuda`` runs ``numerics.int_matmul`` on the card: ``a @ b``
with int32 accumulation that wraps mod 2³², for int8 or int32 (int16
lifted) operands, as an int32 result.  It replaces the JAX package's
``repro.core.numerics.int_matmul``, an XLA ``dot_general`` with
``preferred_element_type=int32`` (no Pallas kernel).  Source:
``csrc/int_matmul.cu``, which notes each route's bound and design.

``plan`` picks one of three routes from the operands' dtypes, shapes,
strides and alignment:

* ``T``, thin products (little work, or min(M, N) ≤ ``THIN_MN``: the
  learning and output layers): one launch on the CUDA cores that reads
  both operands through their strides (no copy of a ``w.T`` / ``x.T``
  view), with no memset and no scratch;
* ``W``, int8 × int8 with 16 | K, a K-major (row-major) and b K-major (the
  (K, N) view of a row-major (N, K) tensor) or N-major (one transpose pass
  first), bases and row strides 16-byte aligned: ``wgmma`` fed by TMA;
* ``D``, everything else: the split-K digit GEMM of #1/#2 on contiguous
  copies.

The wrapper takes CUDA tensors only; ``numerics.int_matmul`` sends CPU
tensors to ``a @ b``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib

#: route T (csrc/int_matmul.cu has the card's timings behind these): for
#: operands route W takes, at most W_THIN_WORK multiply-adds; for the
#: others, min(M, N) ≤ THIN_MN, or min(M, N) ≤ THIN_SIDE and at most
#: THIN_WORK multiply-adds
THIN_MN = 16
THIN_SIDE = 128
THIN_WORK = 2 ** 26
W_THIN_WORK = 2 ** 25
#: route T's output tile (rows, cols): one arrival counter each
THIN_TILE = (64, 16)
#: route W reads K in 16-byte TMA rows; its transpose pass's grid holds K
#: in 64-row tiles
W_ALIGN = 16
W_MAX_K = 64 * 65535
_I32 = 2 ** 31


def _k_major(shape, strides, ptr, rows_dim: int) -> bool:
    """A 2-D int8 operand whose K dimension has unit stride and whose rows
    (dimension ``rows_dim``) start on 16-byte boundaries, as TMA reads it."""
    k_dim = 1 - rows_dim
    ld = strides[rows_dim]
    return (strides[k_dim] == 1 and ld % W_ALIGN == 0 and shape[k_dim] <= ld < _I32
            and ptr % W_ALIGN == 0)


def plan(a_shape, a_dtype, a_strides, a_ptr, b_shape, b_dtype, b_strides, b_ptr) -> str:
    """The route of ``a (M, K) @ b (K, N)``: ``"T"``, ``"W"``, ``"WT"``
    (route W after b's transpose pass) or ``"D"``.  Operands are int8 or
    int32 (the wrapper lifts int16); raises ``ValueError`` on anything no
    route takes."""
    for dt in (a_dtype, b_dtype):
        if dt not in (torch.int8, torch.int32):
            raise ValueError(f"int_matmul: int8 or int32 operands expected, got {dt}")
    if len(a_shape) != 2 or len(b_shape) != 2 or a_shape[1] != b_shape[0]:
        raise ValueError(f"int_matmul: bad shapes {tuple(a_shape)} @ {tuple(b_shape)}")
    (m, k), n = a_shape, b_shape[1]
    if max(m, n, k) >= _I32 or m * n >= _I32:
        raise ValueError("int_matmul: dimensions must fit int32")
    wgmma = None
    if a_dtype == torch.int8 and b_dtype == torch.int8 and k % W_ALIGN == 0 \
            and _k_major(a_shape, a_strides, a_ptr, 0):
        if _k_major(b_shape, b_strides, b_ptr, 1):
            wgmma = "W"
        elif b_strides[1] == 1 and k <= W_MAX_K and b_strides[0] < _I32:
            wgmma = "WT"
    side, work = min(m, n), m * n * k
    if wgmma is not None:
        thin = work <= W_THIN_WORK
    else:
        thin = side <= THIN_MN or side <= THIN_SIDE and work <= THIN_WORK
    if thin:
        if max(*a_strides, *b_strides) >= _I32:
            raise ValueError("int_matmul: strides of a thin product must fit int32")
        return "T"
    if wgmma is not None:
        return wgmma
    if -(-m // cuda_lib.GEMM_TILE) > 65535:  # route D: one block row per 64 rows
        raise ValueError("int_matmul: M exceeds the kernel's grid")
    return "D"


def _lift(t: torch.Tensor) -> torch.Tensor:
    """int16 lifted to int32; int8 and int32 as they are."""
    if t.dtype not in (torch.int8, torch.int16, torch.int32):
        raise ValueError(f"int_matmul: integer operands expected, got {t.dtype}")
    return t.to(torch.int32) if t.dtype == torch.int16 else t


def _scratch(lib: ctypes.CDLL, device: torch.device, *shape: int) -> torch.Tensor:
    """Route D's scratch (the digit flags, b's tile map and digit planes,
    a's digit planes, the splits' slots), sized by the library; its
    contents need no zeroing."""
    fn = lib.int_matmul_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(shape)
        fn.restype = ctypes.c_longlong
    return torch.empty(fn(*shape), dtype=torch.uint8, device=device)


def _run_t(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, stream: int) -> None:
    (m, k), n = a.shape, b.shape[1]
    lib, launch = cuda_lib.entry("int_matmul", "int_matmul_thin_launch", 5, 10)
    ws, arrivals = cuda_lib.split_workspace(a.device, m, n, THIN_TILE, stream)
    err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), arrivals.data_ptr(),
                 m, n, k, *a.stride(), *b.stride(), int(a.dtype == torch.int8),
                 int(b.dtype == torch.int8), cuda_lib.sm_count(a.device), stream)
    cuda_lib.check(lib, err, "int_matmul (route T)")
    int_matmul_cuda.routes["T"].add()


def _run_w(a: torch.Tensor, bt: torch.Tensor, out: torch.Tensor, stream: int) -> None:
    """Route W on ``bt`` (N, K), K-major."""
    (m, k), n = a.shape, bt.shape[0]
    lib, launch = cuda_lib.entry("int_matmul", "int_matmul_wgmma_launch", 3, 6)
    err = launch(a.data_ptr(), bt.data_ptr(), out.data_ptr(), a.stride(0), bt.stride(0), m, n, k,
                 cuda_lib.sm_count(a.device), stream)
    cuda_lib.check(lib, err, "int_matmul (route W)")
    int_matmul_cuda.routes["W"].add()


def transpose_int8(b: torch.Tensor, stream: int) -> torch.Tensor:
    """``b`` (K, N) int8 with unit column stride, as a row-major (N, K)
    tensor: route W's transpose pass (one launch on ``stream``)."""
    k, n = b.shape
    out = torch.empty((n, k), dtype=torch.int8, device=b.device)
    lib, launch = cuda_lib.entry("int_matmul", "int8_transpose_launch", 2, 3)
    err = launch(b.data_ptr(), out.data_ptr(), k, n, b.stride(0), stream)
    cuda_lib.check(lib, err, "int_matmul (transpose pass)")
    return out


def _run_d(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, stream: int) -> None:
    a, b = a.contiguous(), b.contiguous()
    (m, k), n = a.shape, b.shape[1]
    a_int8, b_int8 = int(a.dtype == torch.int8), int(b.dtype == torch.int8)
    # an int8 a whose rows start 16-byte aligned is read as it is
    a_direct = int(bool(a_int8) and k % 16 == 0 and a.data_ptr() % 16 == 0)
    lib, launch = cuda_lib.entry("int_matmul", "int_matmul_launch", 5, 7)
    sms = cuda_lib.sm_count(a.device)
    scratch = _scratch(lib, a.device, m, n, k, a_int8, b_int8, a_direct, sms)
    _, arrivals = cuda_lib.split_workspace(a.device, m, n, stream=stream)
    err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 arrivals.data_ptr(), m, n, k, a_int8, b_int8, a_direct, sms, stream)
    cuda_lib.check(lib, err, "int_matmul (route D)")
    int_matmul_cuda.routes["D"].add()


def run_route(route: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` through ``route`` (a value of ``plan``) on CUDA tensors
    that the route takes; ``int_matmul_cuda`` calls it with ``plan``'s
    choice."""
    m, n = a.shape[0], b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if a.shape[1] == 0:
        return out.zero_()
    if route not in _RUNS:
        raise ValueError(f"int_matmul: unknown route {route!r}")
    if a.device.index == torch.cuda.current_device():
        _RUNS[route](a, b, out, torch.cuda.current_stream(a.device).cuda_stream)
    else:
        with torch.cuda.device(a.device):
            _RUNS[route](a, b, out, torch.cuda.current_stream(a.device).cuda_stream)
    return out


_RUNS = {
    "T": _run_t,
    "W": lambda a, b, out, stream: _run_w(a, b.t(), out, stream),
    "WT": lambda a, b, out, stream: _run_w(a, transpose_int8(b, stream), out, stream),
    "D": _run_d,
}


def int_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` mod 2³² on the card: a (M,K), b (K,N) → (M,N) int32,
    through the route ``plan`` picks (one device launch on T and W with a
    K-major b, two on W with an N-major b, a memset and at most three on
    D)."""
    a, b = _lift(a), _lift(b)
    cuda_lib.require_cuda("int_matmul", a, b)
    route = plan(tuple(a.shape), a.dtype, a.stride(), a.data_ptr(),
                 tuple(b.shape), b.dtype, b.stride(), b.data_ptr())
    out = run_route(route, a, b)
    if out.numel() and a.shape[1]:
        int_matmul_cuda.launches.add()
    return out


#: calls of the kernel that launched (the wrapper adds one per call)
int_matmul_cuda.launches = cuda_lib.LaunchCounter()
#: launches per route ("WT" counts as "W"), added where each route launches
int_matmul_cuda.routes = {r: cuda_lib.LaunchCounter() for r in ("T", "W", "D")}
