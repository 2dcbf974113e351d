"""Dispatch for the training max-pool kernels, and their plain versions.

``maxpool_fwd`` pools a block's activation 2×2 with stride 2 and returns
each window's first-max position as one byte; ``maxpool_bwd`` routes the
pooled gradient back to that position.  Together they equal
``core.layers.maxpool_forward`` / ``maxpool_backward`` (the one-hot's
position is ``idx``), which stay the unfused reference composition.

``backend`` has ``nitro_matmul.ops``' vocabulary: ``cuda`` (the kernels of
``maxpool.py``), ``reference`` (``maxpool_fwd_ref`` / ``maxpool_bwd_ref``
below) and ``auto`` (``cuda`` for CUDA tensors, ``reference`` for CPU
ones).  Nothing falls back to another backend.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import numerics
from repro_torch.core.layers import window_view_2x2
from repro_torch.kernels.maxpool.maxpool import maxpool_bwd_cuda, maxpool_fwd_cuda
from repro_torch.kernels.nitro_matmul.ops import resolve_backend
from repro_torch.obs import trace


def maxpool_fwd_ref(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain ``maxpool_fwd``: a strict ``>`` scan over the window in
    ``window_view_2x2``'s order, so ties keep the first max."""
    win = window_view_2x2(a.to(numerics.INT_DTYPE))
    out = win[:, :, :, 0]
    idx = torch.zeros(out.shape, dtype=torch.uint8, device=a.device)
    for pos in (1, 2, 3):
        v = win[:, :, :, pos]
        above = v > out
        out = torch.where(above, v, out)
        idx.masked_fill_(above, pos)
    return out, idx


def maxpool_bwd_ref(g: torch.Tensor, idx: torch.Tensor,
                    in_shape: tuple[int, int, int, int]) -> torch.Tensor:
    """Plain ``maxpool_bwd``: ``g`` at each window's ``idx`` position, 0 at
    the other three and over a cropped odd edge."""
    n, h, w, c = in_shape
    h2, w2 = h // 2, w // 2
    pos = torch.arange(4, dtype=torch.uint8, device=g.device).view(1, 1, 1, 4, 1)
    win = torch.where(idx.unsqueeze(3) == pos, g.to(numerics.INT_DTYPE).unsqueeze(3), 0)
    d = win.reshape(n, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h2 * 2, w2 * 2, c)
    if (h2 * 2, w2 * 2) != (h, w):  # zeros over the cropped odd edge
        d = F.pad(d, (0, 0, 0, w - w2 * 2, 0, h - h2 * 2))
    return d


@trace.spanned("dispatch.maxpool_fwd")
def maxpool_fwd(a: torch.Tensor, *, backend: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """2×2 stride-2 integer max-pool of ``a`` (N,H,W,C): ``(out, idx)``,
    out int32 and idx uint8 (the first max's window position ``di·2 + dj``),
    both (N,H//2,W//2,C); odd H or W cropped."""
    numerics.assert_int(a, "maxpool input")
    if resolve_backend(backend, a.device) == "reference":
        return maxpool_fwd_ref(a)
    return maxpool_fwd_cuda(a)


@trace.spanned("dispatch.maxpool_bwd")
def maxpool_bwd(g: torch.Tensor, idx: torch.Tensor, in_shape: tuple[int, int, int, int], *,
                backend: str = "auto") -> torch.Tensor:
    """The pool's backward: δ int32 of ``in_shape``, ``g`` at each window's
    ``idx`` position and 0 elsewhere."""
    numerics.assert_int(g, "maxpool gradient")
    if resolve_backend(backend, g.device) == "reference":
        return maxpool_bwd_ref(g, idx, in_shape)
    return maxpool_bwd_cuda(g, idx, in_shape)
