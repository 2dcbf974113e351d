from repro_torch.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul,
    nitro_matmul_fwd,
    nitro_matmul_grad_w,
    nitro_matmul_grad_w_opt,
)
from repro_torch.kernels.nitro_matmul.ops import (
    BACKENDS,
    OPERAND_DTYPES,
    check_alpha_inv,
    fused_matmul,
    fused_matmul_fwd,
    grad_w_matmul,
    grad_w_opt_matmul,
    resolve_backend,
    resolve_operand_dtype,
)
from repro_torch.kernels.nitro_matmul.ref import (
    masked_delta,
    nitro_matmul_fwd_ref,
    nitro_matmul_grad_w_opt_ref,
    nitro_matmul_grad_w_ref,
    nitro_matmul_ref,
)

__all__ = [
    "BACKENDS",
    "OPERAND_DTYPES",
    "check_alpha_inv",
    "fused_matmul",
    "fused_matmul_fwd",
    "grad_w_matmul",
    "grad_w_opt_matmul",
    "masked_delta",
    "nitro_matmul",
    "nitro_matmul_fwd",
    "nitro_matmul_fwd_ref",
    "nitro_matmul_grad_w",
    "nitro_matmul_grad_w_opt",
    "nitro_matmul_grad_w_opt_ref",
    "nitro_matmul_grad_w_ref",
    "nitro_matmul_ref",
    "resolve_backend",
    "resolve_operand_dtype",
]
