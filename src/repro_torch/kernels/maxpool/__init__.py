from repro_torch.kernels.maxpool.maxpool import maxpool_bwd_cuda, maxpool_fwd_cuda
from repro_torch.kernels.maxpool.ops import (
    maxpool_bwd,
    maxpool_bwd_ref,
    maxpool_fwd,
    maxpool_fwd_ref,
)

__all__ = ["maxpool_bwd", "maxpool_bwd_cuda", "maxpool_bwd_ref", "maxpool_fwd",
           "maxpool_fwd_cuda", "maxpool_fwd_ref"]
