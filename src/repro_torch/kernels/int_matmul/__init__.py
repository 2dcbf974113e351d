from repro_torch.kernels.int_matmul.int_matmul import int_matmul_cuda, plan, run_route
from repro_torch.kernels.int_matmul.ref import wgmma_matmul

__all__ = ["int_matmul_cuda", "plan", "run_route", "wgmma_matmul"]
