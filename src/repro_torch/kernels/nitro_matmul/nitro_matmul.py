"""Python wrapper of the hand-written ``nitro_matmul`` CUDA kernel.

Replaces the Pallas TPU kernel ``repro.kernels.nitro_matmul.nitro_matmul``
(``_nitro_matmul_kernel``): ``relu(⌊x @ w / SF⌋) − μ`` (or the scale
alone) from one int32 accumulator, written as int8 or int32.  Source:
``csrc/nitro_matmul.cu``, which also notes the kernel's bound and design.

The wrapper takes CUDA tensors only; the dispatcher (``ops.fused_matmul``)
sends CPU tensors to the plain version in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.activations import mu_int8
from repro_torch.core.scaling import pow2_split
from repro_torch.kernels import cuda_lib

def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.nitro_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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

    ``operand_dtype='int8'`` takes int8 operands as they are; ``'int32'``
    lifts int8/int16/int32 operands to int32 (as ``_accumulate_tile``
    does).  Both give the same result.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes x{tuple(x.shape)} @ w{tuple(w.shape)}")
    x, w, alpha_inv = cuda_lib.check_inputs(
        "nitro_matmul", x, w, operand_dtype=operand_dtype, out_dtype=out_dtype,
        apply_relu=apply_relu, alpha_inv=alpha_inv)
    m, k = x.shape
    n = w.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError("dimensions must fit int32")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _bind(cuda_lib.load("nitro_matmul"))
    shift, residual = pow2_split(sf)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nitro_matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
            shift, residual, alpha_inv, mu_int8(alpha_inv) if apply_relu else 0,
            int(apply_relu), int(operand_dtype == "int8"),
            int(out_dtype == torch.int8), stream,
        )
    cuda_lib.check(lib, err, "nitro_matmul")
    nitro_matmul.launches.add()
    return out


#: launches of the CUDA kernel (the wrapper adds one per launch)
nitro_matmul.launches = cuda_lib.LaunchCounter()
