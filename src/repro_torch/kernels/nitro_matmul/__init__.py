from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul
from repro_torch.kernels.nitro_matmul.ops import (
    BACKENDS,
    OPERAND_DTYPES,
    check_alpha_inv,
    fused_matmul,
    resolve_backend,
    resolve_operand_dtype,
)
from repro_torch.kernels.nitro_matmul.ref import nitro_matmul_ref

__all__ = [
    "BACKENDS",
    "OPERAND_DTYPES",
    "check_alpha_inv",
    "fused_matmul",
    "nitro_matmul",
    "nitro_matmul_ref",
    "resolve_backend",
    "resolve_operand_dtype",
]
