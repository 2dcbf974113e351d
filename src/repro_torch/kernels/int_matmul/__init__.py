from repro_torch.kernels.int_matmul.int_matmul import int_matmul_cuda

__all__ = ["int_matmul_cuda"]
