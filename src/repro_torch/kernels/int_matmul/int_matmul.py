"""Python wrapper of the hand-written exact integer matmul CUDA kernel.

``int_matmul_cuda`` runs ``numerics.int_matmul`` on the card: ``a @ b``
with int32 accumulation that wraps mod 2³², for int8 or int32 (int16
lifted) operands, as an int32 result.  It replaces the JAX package's
``repro.core.numerics.int_matmul``, an XLA ``dot_general`` with
``preferred_element_type=int32`` (no Pallas kernel).  Source:
``csrc/int_matmul.cu``, on ``csrc_common/split_matmul.cuh``'s split-K GEMM
over exact signed base-256 digits on the int8 tensor cores, which notes
the kernel's bound and design.  The wrapper takes CUDA tensors only;
``numerics.int_matmul`` sends CPU tensors to ``a @ b``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib


def _operand(t: torch.Tensor) -> torch.Tensor:
    """An operand as the kernel reads it: int8 or int32, contiguous."""
    if t.dtype not in (torch.int8, torch.int16, torch.int32):
        raise ValueError(f"int_matmul: integer operands expected, got {t.dtype}")
    if t.dtype == torch.int16:
        t = t.to(torch.int32)
    return t.contiguous()


def _scratch(lib: ctypes.CDLL, device: torch.device, *shape: int) -> torch.Tensor:
    """The call's scratch (the digit flags, b's tile map and digit planes,
    a's digit planes, the splits' slots), sized by the library; its
    contents need no zeroing."""
    fn = lib.int_matmul_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(shape)
        fn.restype = ctypes.c_longlong
    return torch.empty(fn(*shape), dtype=torch.uint8, device=device)


def int_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` mod 2³² on the card: a (M,K), b (K,N) → (M,N) int32.

    A memset and at most three device launches; one digit product for
    int8 a and b, up to ten for wide int32 operands, decided on the card.
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int_matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    a, b = _operand(a), _operand(b)
    cuda_lib.require_cuda("int_matmul", a, b)
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31 or m * n >= 2 ** 31:
        raise ValueError("int_matmul: dimensions must fit int32")
    if -(-m // cuda_lib.GEMM_TILE) > 65535:  # one block row per 64 rows of a
        raise ValueError("int_matmul: M exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    a_int8, b_int8 = int(a.dtype == torch.int8), int(b.dtype == torch.int8)
    # an int8 a whose rows start 16-byte aligned is read as it is
    a_direct = int(bool(a_int8) and k % 16 == 0 and a.data_ptr() % 16 == 0)
    lib, launch = cuda_lib.entry("int_matmul", "int_matmul_launch", 5, 7)
    sms = cuda_lib.sm_count(a.device)
    scratch = _scratch(lib, a.device, m, n, k, a_int8, b_int8, a_direct, sms)
    _, arrivals = cuda_lib.split_workspace(a.device, m, n)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     arrivals.data_ptr(), m, n, k, a_int8, b_int8, a_direct, sms, stream)
    cuda_lib.check(lib, err, "int_matmul")
    int_matmul_cuda.launches.add()
    return out


#: launches of the CUDA kernel (the wrapper adds one per launch)
int_matmul_cuda.launches = cuda_lib.LaunchCounter()
