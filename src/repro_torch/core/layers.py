"""Integer layers with hand-derived integer backward passes (port of
``repro.core.layers``).

Every layer exposes a ``forward`` that returns its cache and a
``backward`` that consumes it, all closed over ℤ.  Layout is NHWC /
(batch, features); weights are (fan_in, fan_out) for linear and
(K, K, C_in, C_out) for conv, as in the JAX package.  Conv2D is im2col +
integer matmul, with the patch channel order ``(ki·K + kj)·C + c`` that
``w.reshape(K²C, F)`` expects.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import numerics, prng
from repro_torch.core.init import integer_kaiming_uniform
from repro_torch.core.numerics import floor_div, int_matmul

# ---------------------------------------------------------------------------
# Integer Linear
# ---------------------------------------------------------------------------


def linear_init(key: torch.Tensor, fan_in: int, fan_out: int,
                *, device="cpu") -> dict:
    """IntegerLinear params — no bias (Appendix B.1)."""
    return {"w": integer_kaiming_uniform(
        key, (fan_in, fan_out), fan_in, device=device)}


def linear_forward(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """z = x @ W with int32 accumulation.  Cache = the input."""
    numerics.assert_int(x, "linear input")
    return int_matmul(x, params["w"]), x


def linear_backward(
    params: dict,
    cache: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    fuse_bwd: bool = True,
    backend: str = "auto",
    need_grad_x: bool = True,
) -> tuple[torch.Tensor | None, dict]:
    """``(grad_x, {"w": grad_W})`` through ``kernels.grad_ops``: grad_x =
    g @ Wᵀ, grad_W = xᵀ @ g.

    With ``z_star`` (a block's forward layer) the NITRO-ReLU-bwd/STE step
    runs inside the gradient kernels (``fuse_bwd=True``) or as the
    unfused composition; without it (learning/output layers) both are
    plain matmuls.  ``need_grad_x=False`` skips grad_x (``None``), as the
    LES step does (see ``grad_ops``).
    """
    from repro_torch.kernels import grad_ops  # lazy: grad_ops imports layers

    grad_x, grad_w = grad_ops.linear_grads(
        cache, params["w"], grad_out, z_star=z_star, alpha_inv=alpha_inv,
        fuse_bwd=fuse_bwd, backend=backend, need_grad_x=need_grad_x,
    )
    return grad_x, {"w": grad_w}


def linear_update(
    params: dict,
    cache: torch.Tensor,
    grad_out: torch.Tensor,
    opt_state,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    fuse_bwd: bool = True,
    backend: str = "auto",
    need_grad_x: bool = True,
) -> tuple[torch.Tensor | None, dict]:
    """``linear_backward`` + IntegerSGD in one pass: ``(grad_x, {"w": W′})``.

    The update runs as the grad_W kernel's flush
    (``grad_ops.linear_weight_update``), so grad_W is never written —
    bitwise ``linear_backward`` then ``optimizer.apply_update``.
    """
    from repro_torch.kernels import grad_ops  # lazy: grad_ops imports layers

    grad_x, w_new = grad_ops.linear_weight_update(
        cache, params["w"], grad_out, opt_state, z_star=z_star,
        alpha_inv=alpha_inv, fuse_bwd=fuse_bwd, backend=backend,
        need_grad_x=need_grad_x,
    )
    return grad_x, {"w": w_new}


# ---------------------------------------------------------------------------
# Integer Conv2D (K×K, stride 1, 'same' padding) via im2col + matmul
# ---------------------------------------------------------------------------


def conv_init(key: torch.Tensor, in_channels: int, out_channels: int,
              kernel_size: int = 3, *, device="cpu") -> dict:
    fan_in = kernel_size * kernel_size * in_channels
    shape = (kernel_size, kernel_size, in_channels, out_channels)
    return {"w": integer_kaiming_uniform(key, shape, fan_in, device=device)}


def im2col(x: torch.Tensor, kernel_size: int, padding: int) -> torch.Tensor:
    """Extract K×K patches: (N,H,W,C) → (N,H,W,K·K·C), zero 'same' halo."""
    n, h, w, c = x.shape
    k = kernel_size
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    shifts = [xp[:, i:i + h, j:j + w, :] for i in range(k) for j in range(k)]
    return torch.stack(shifts, dim=3).reshape(n, h, w, k * k * c)


def conv_im2col_operands(
    w: torch.Tensor, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,H,W,C) input + (K,K,C,F) weight → (N·H·W, K²C) patches and the
    (K²C, F) flattened weight."""
    k = w.shape[0]
    n, h, ww, c = x.shape
    patches = im2col(x, k, k // 2).reshape(n * h * ww, k * k * c)
    return patches, w.reshape(-1, w.shape[-1])


class ConvCache(NamedTuple):
    x: torch.Tensor  # input activations (N,H,W,C)


def conv_forward(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, ConvCache]:
    """z[n,h,w,f] = Σ_{i,j,c} x[n,h+i-p,w+j-p,c] · W[i,j,c,f] (int32)."""
    numerics.assert_int(x, "conv input")
    n, h, ww, _ = x.shape
    patches, w_flat = conv_im2col_operands(params["w"], x)
    z = int_matmul(patches, w_flat).reshape(n, h, ww, w_flat.shape[-1])
    return z, ConvCache(x=x)


def conv_backward(
    params: dict,
    cache: ConvCache,
    grad_out: torch.Tensor,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    fuse_bwd: bool = True,
    conv_mode: str = "stream",
    backend: str = "auto",
    need_grad_x: bool = True,
) -> tuple[torch.Tensor | None, dict]:
    """``(grad_x, {"w": grad_W})`` through ``kernels.grad_ops``.

    grad_W correlates the input patches with g; grad_x is the 'full'
    correlation of g with the rotated, channel-swapped kernel.  Both
    stream their patches (``conv_mode='stream'``) or use explicit im2col
    (``'materialise'``); with ``z_star`` the NITRO-ReLU derivative masks
    δ inside the kernels (``fuse_bwd=True``) or beforehand.
    ``need_grad_x=False`` skips grad_x (``None``), as the LES step does.
    """
    from repro_torch.kernels import grad_ops  # lazy: grad_ops imports layers

    grad_x, grad_w = grad_ops.conv_grads(
        cache.x, params["w"], grad_out, z_star=z_star, alpha_inv=alpha_inv,
        fuse_bwd=fuse_bwd, backend=backend, conv_mode=conv_mode,
        need_grad_x=need_grad_x,
    )
    return grad_x, {"w": grad_w}


def conv_update(
    params: dict,
    cache: ConvCache,
    grad_out: torch.Tensor,
    opt_state,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    fuse_bwd: bool = True,
    conv_mode: str = "stream",
    backend: str = "auto",
    need_grad_x: bool = True,
) -> tuple[torch.Tensor | None, dict]:
    """``conv_backward`` + IntegerSGD in one pass: ``(grad_x, {"w": W′})``.

    Stream mode applies the update in the streaming grad_W kernel's flush
    (``grad_ops.conv_weight_update``); the escape hatches compose the
    gradient with ``optimizer.apply_update``, bitwise the same.
    """
    from repro_torch.kernels import grad_ops  # lazy: grad_ops imports layers

    grad_x, w_new = grad_ops.conv_weight_update(
        cache.x, params["w"], grad_out, opt_state, z_star=z_star,
        alpha_inv=alpha_inv, fuse_bwd=fuse_bwd, backend=backend,
        conv_mode=conv_mode, need_grad_x=need_grad_x,
    )
    return grad_x, {"w": w_new}


# ---------------------------------------------------------------------------
# MaxPool2D (2×2, stride 2) — integer max with argmax routing on backward
# ---------------------------------------------------------------------------


class PoolCache(NamedTuple):
    onehot: torch.Tensor  # (N,h,w,4,C) int32 one-hot of the first max per window
    in_shape: tuple[int, int, int, int]


def window_view_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) → (N,H//2,W//2,4,C), cropping odd trailing rows/cols."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : h2 * 2, : w2 * 2, :]
    x = x.reshape(n, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h2, w2, 4, c)


def maxpool_forward(x: torch.Tensor) -> tuple[torch.Tensor, PoolCache]:
    """2×2 stride-2 integer max-pool (floor pooling for odd sizes).

    The cache routes each window's gradient to its *first* max, as
    ``jnp.argmax`` picks it.
    """
    numerics.assert_int(x, "maxpool input")
    win = window_view_2x2(x)
    out = win.amax(dim=3)
    is_max = win == out.unsqueeze(3)
    first = is_max & (is_max.cumsum(dim=3) == 1)
    return out, PoolCache(onehot=first.to(numerics.INT_DTYPE),
                          in_shape=tuple(x.shape))


def maxpool_backward(cache: PoolCache, grad_out: torch.Tensor) -> torch.Tensor:
    """Route the gradient to the (first) max position of each 2×2 window."""
    n, h, w, c = cache.in_shape
    h2, w2 = h // 2, w // 2
    g = grad_out.unsqueeze(3) * cache.onehot  # (N,h2,w2,4,C)
    g = g.reshape(n, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    g = g.reshape(n, h2 * 2, w2 * 2, c)
    if (h2 * 2, w2 * 2) != (h, w):  # repad cropped odd edges with zeros
        g = F.pad(g, (0, 0, 0, w - w2 * 2, 0, h - h2 * 2))
    return g


# ---------------------------------------------------------------------------
# Adaptive integer average pooling (learning-layer dimensionality reduction)
# ---------------------------------------------------------------------------


class AvgPoolCache(NamedTuple):
    in_shape: tuple[int, int, int, int]
    window: int
    target: int


def avgpool_grid(h: int, w: int, c: int, target: int) -> tuple[int, int]:
    """``avgpool_to``'s grid: (s, window) with s the largest grid whose
    s²·C ≤ ``target`` features, clamped to the spatial size."""
    s = max(math.isqrt(max(target // c, 1)), 1)
    s = min(s, h, w)
    return s, h // s


def avgpool_to(x: torch.Tensor, target: int) -> tuple[torch.Tensor, AvgPoolCache]:
    """Integer adaptive average pool (N,H,W,C) → (N,s,s,C): Σ // count.

    The window sums stay int32 as in the JAX package (≤ 127·window², far
    from overflow).
    """
    n, h, w, c = x.shape
    s, window = avgpool_grid(h, w, c, target)
    xs = x[:, : s * window, : s * window, :].reshape(n, s, window, s, window, c)
    out = floor_div(numerics.sum_int32(xs, dim=(2, 4)), window * window)
    return out, AvgPoolCache(in_shape=tuple(x.shape), window=window, target=s)


def avgpool_to_backward(cache: AvgPoolCache, grad_out: torch.Tensor) -> torch.Tensor:
    """STE unpool: replicate each pooled grad across its window, zero-pad."""
    n, h, w, c = cache.in_shape
    s, window = cache.target, cache.window
    g = grad_out[:, :, None, :, None, :].expand(n, s, window, s, window, c)
    g = g.reshape(n, s * window, s * window, c)
    pad_h, pad_w = h - s * window, w - s * window
    if pad_h or pad_w:
        g = F.pad(g, (0, 0, 0, pad_w, 0, pad_h))
    return g


# ---------------------------------------------------------------------------
# Integer inverted dropout
# ---------------------------------------------------------------------------

_DROPOUT_FP_BITS = 8  # fixed-point denominator 2^8 for the 1/(1-p) rescale


class DropoutCache(NamedTuple):
    mask: torch.Tensor
    q: int


def dropout_forward(key: torch.Tensor | None, x: torch.Tensor, rate: float,
                    *, dp_axis=None, dp_shards: int = 1) -> tuple[torch.Tensor, DropoutCache]:
    """Integer inverted dropout: out = ⌊x·mask·q / 2⁸⌋, q = round(256/(1−p)).

    The Bernoulli mask is ``bits < ⌊keep·2³²⌋`` on the threefry bits of
    ``key`` — the JAX package's mask for the same key.  The uint32 compare
    runs in int64.  rate == 0 is the identity.

    Under data parallelism (``dp_axis``, a ``parallel.dp.DataAxis`` of
    ``dp_shards`` ranks) the bits of a rank's rows are not the bits of a
    smaller batch: every rank draws the **global-batch** bits
    ``(local_b·dp_shards, …)`` from the shared key and keeps its rows
    ``[rank·local_b, (rank+1)·local_b)``, so the masks are the
    single-device run's at any rank count.
    """
    if rate <= 0.0:
        ones = torch.ones((), dtype=numerics.INT_DTYPE, device=x.device)
        return x, DropoutCache(mask=ones, q=1 << _DROPOUT_FP_BITS)
    keep = 1.0 - rate
    q = int(round((1 << _DROPOUT_FP_BITS) / keep))
    threshold = min(int(keep * (1 << 32)), (1 << 32) - 1)
    if dp_axis is not None and dp_shards > 1:
        local_b = x.shape[0]
        bits = prng.bits(key, (local_b * dp_shards, *x.shape[1:]), device=x.device)
        bits = bits[dp_axis.rank * local_b:(dp_axis.rank + 1) * local_b]
    else:
        bits = prng.bits(key, x.shape, device=x.device)
    mask = (bits < threshold).to(numerics.INT_DTYPE)
    out = floor_div(x * mask * q, 1 << _DROPOUT_FP_BITS)
    return out, DropoutCache(mask=mask, q=q)


def dropout_backward(cache: DropoutCache, grad_out: torch.Tensor) -> torch.Tensor:
    return floor_div(grad_out * cache.mask * cache.q, 1 << _DROPOUT_FP_BITS)


# ---------------------------------------------------------------------------
# Flatten
# ---------------------------------------------------------------------------


def flatten_forward(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    return x.reshape(x.shape[0], -1), tuple(x.shape)


def flatten_backward(in_shape: tuple[int, ...], grad_out: torch.Tensor) -> torch.Tensor:
    return grad_out.reshape(in_shape)
