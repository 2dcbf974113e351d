"""Python wrappers of the hand-written training max-pool CUDA kernels.

  * ``maxpool_fwd_cuda``: the 2×2 stride-2 integer max-pool of a training
    block, ``(out, idx)`` with ``idx`` each window's first-max position
    (0..3, ``di·2 + dj``) as one byte;
  * ``maxpool_bwd_cuda``: the gradient routed to that position, zero
    elsewhere and over a cropped odd edge.

They replace no Pallas kernel (the JAX package pools with jnp ops); they
replace the eager one-hot chain of ``core.layers.maxpool_forward`` /
``maxpool_backward`` on the fused training path.  Source:
``csrc/maxpool.cu``, which notes the kernels' bound and design.  The
wrappers take CUDA tensors only; ``ops.py`` sends CPU tensors to the plain
versions beside its dispatchers.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.obs import trace


def _check_size(name: str, t: torch.Tensor) -> None:
    """The kernels index in 32 bits."""
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: tensors of 2^31 values or more exceed the kernel's indexing")


@trace.spanned("kernel.maxpool_fwd")
def maxpool_fwd_cuda(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """2×2 stride-2 max-pool of ``a`` (N,H,W,C), integer, on the card:
    ``(out, idx)``, out int32 and idx uint8, both (N,H//2,W//2,C); odd H or
    W cropped.  One launch (none for an empty output)."""
    if a.ndim != 4:
        raise ValueError(f"maxpool_fwd: expected (N,H,W,C), got {tuple(a.shape)}")
    cuda_lib.require_cuda("maxpool_fwd", a)
    (a,) = cuda_lib.as_int32("maxpool_fwd", a)
    _check_size("maxpool_fwd", a)
    n, h, w, c = a.shape
    out = torch.empty((n, h // 2, w // 2, c), dtype=torch.int32, device=a.device)
    idx = torch.empty(out.shape, dtype=torch.uint8, device=a.device)
    if out.numel() == 0:
        return out, idx
    lib, launch = cuda_lib.entry("maxpool", "maxpool_fwd_launch", 3, 5)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(a.data_ptr(), out.data_ptr(), idx.data_ptr(), n, h, w, c,
                     cuda_lib.sm_count(a.device), stream)
    cuda_lib.check(lib, err, "maxpool_fwd")
    maxpool_fwd_cuda.launches.add()
    return out, idx


@trace.spanned("kernel.maxpool_bwd")
def maxpool_bwd_cuda(g: torch.Tensor, idx: torch.Tensor,
                     in_shape: tuple[int, int, int, int]) -> torch.Tensor:
    """The pool's backward on the card: δ int32 of ``in_shape`` (N,H,W,C),
    ``g`` (N,H//2,W//2,C) at each window's ``idx`` position and 0 at the
    other three and over a cropped odd edge.  One launch (none for an
    empty δ)."""
    n, h, w, c = (int(s) for s in in_shape)
    pooled = (n, h // 2, w // 2, c)
    if tuple(g.shape) != pooled or tuple(idx.shape) != pooled:
        raise ValueError(f"maxpool_bwd: g {tuple(g.shape)} and idx {tuple(idx.shape)} must "
                         f"both be {pooled} for an input of {(n, h, w, c)}")
    if idx.dtype != torch.uint8:
        raise ValueError(f"maxpool_bwd: idx must be uint8, got {idx.dtype}")
    cuda_lib.require_cuda("maxpool_bwd", g, idx)
    (g,) = cuda_lib.as_int32("maxpool_bwd", g)
    idx = idx.contiguous()
    d = torch.empty((n, h, w, c), dtype=torch.int32, device=g.device)
    _check_size("maxpool_bwd", d)
    if d.numel() == 0:
        return d
    lib, launch = cuda_lib.entry("maxpool", "maxpool_bwd_launch", 3, 5)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(g.data_ptr(), idx.data_ptr(), d.data_ptr(), n, h, w, c,
                     cuda_lib.sm_count(g.device), stream)
    cuda_lib.check(lib, err, "maxpool_bwd")
    maxpool_bwd_cuda.launches.add()
    return d


#: launches of each CUDA kernel
maxpool_fwd_cuda.launches = cuda_lib.LaunchCounter()
maxpool_bwd_cuda.launches = cuda_lib.LaunchCounter()
