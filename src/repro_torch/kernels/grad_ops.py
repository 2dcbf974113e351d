"""Backward dispatcher for the integer gradients and updates (port of
``repro.kernels.grad_ops``).

``linear_grads`` / ``conv_grads`` take the raw block gradient δ (after
the dropout/pool backwards) and, for a block's forward layers, the
cached pre-ReLU ``z_star``, and return ``(grad_x, grad_w)``:

``fuse_bwd=True`` (default)
    the NITRO-ReLU derivative + scaling STE runs inside the gradient
    kernels as δ is loaded (``*_grad_w`` and ``*_grad_x``; on the
    reference backend the plain versions compose the same ops), so the
    masked δ is never materialised;
``fuse_bwd=False``
    the escape hatch: ``masked_delta`` materialises the masked δ, then
    plain integer matmuls run (the conv through its dispatchers without
    ``z_star``) — bitwise the same.  The conv's ``conv_mode='materialise'``
    pre-masks the same way: its im2col reads the whole δ anyway.

``z_star=None`` is the learning/output layers' backward (their scaling
STE is the identity): two plain ``int_matmul``\\ s for the linear layer.

``linear_weight_update`` / ``conv_weight_update`` are the ``fuse_opt``
twins: they return ``(grad_x, W′)``, the IntegerSGD step running in the
grad_W kernel's flush (``grad_w_opt_matmul`` / ``conv_grad_w_opt``), so
grad_W is never written.  Their escape hatches (``z_star=None``,
``fuse_bwd=False``, and for the conv ``conv_mode='materialise'``)
compute the gradients as above and then run ``optimizer.apply_update``
— bitwise the same.

``tiles`` (a ``kernels.autotune.TileConfig``) goes to every gradient
dispatcher, as in the JAX package; ``None`` makes each look its own
problem up in the autotune cache.

``need_grad_x=False`` returns ``None`` for grad_x and computes nothing
for it.  It is no feature of its own: it does eagerly what XLA's
dead-code removal does to the jitted JAX step, which discards grad_x
(LES confines gradients to the block), so the LES step here launches
no ``*_grad_x`` kernel, as the compiled JAX step runs none.
"""

from __future__ import annotations

import torch

from repro_torch.core import optimizer as opt
from repro_torch.core.numerics import int_matmul
from repro_torch.kernels.autotune.tiles import TileConfig
from repro_torch.kernels.nitro_conv import ops as conv_ops
from repro_torch.kernels.nitro_matmul import ops as mm_ops
from repro_torch.kernels.nitro_matmul.ref import masked_delta


def linear_grads(
    x: torch.Tensor,
    w: torch.Tensor,
    delta: torch.Tensor,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    fuse_bwd: bool = True,
    backend: str = "auto",
    tiles: TileConfig | None = None,
    need_grad_x: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """IntegerLinear backward: ``(grad_x, grad_w)``.

    ``grad_w = xᵀ @ f(δ)`` and ``grad_x = f(δ) @ wᵀ``, with ``f`` the
    NITRO-ReLU derivative + STE when ``z_star`` is given (inside the
    kernels unless ``fuse_bwd=False``) and the identity otherwise.
    """
    if z_star is not None and not fuse_bwd:
        delta = masked_delta(delta, z_star, alpha_inv)
        z_star = None
    if z_star is None:
        grad_x = int_matmul(delta, w.T) if need_grad_x else None
        return grad_x, int_matmul(x.T, delta)
    grad_w = mm_ops.grad_w_matmul(x, delta, z_star, alpha_inv=alpha_inv,
                                  backend=backend, tiles=tiles)
    grad_x = None
    if need_grad_x:
        grad_x = mm_ops.grad_x_matmul(delta, z_star, w, alpha_inv=alpha_inv,
                                      backend=backend, tiles=tiles)
    return grad_x, grad_w


def conv_grads(
    x: torch.Tensor,
    w: torch.Tensor,
    delta: torch.Tensor,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    fuse_bwd: bool = True,
    backend: str = "auto",
    conv_mode: str = "stream",
    tiles: TileConfig | None = None,
    need_grad_x: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """IntegerConv2D backward: ``(grad_x, grad_w)``, both through the conv
    dispatchers (streamed or materialised patches)."""
    if z_star is not None and (
        not fuse_bwd or conv_ops.resolve_conv_mode(conv_mode) == "materialise"
    ):
        delta = masked_delta(delta, z_star, alpha_inv)
        z_star = None
    grad_w = conv_ops.conv_grad_w(
        x, delta, kernel_size=w.shape[0], z_star=z_star, alpha_inv=alpha_inv,
        backend=backend, conv_mode=conv_mode, tiles=tiles,
    )
    grad_x = None
    if need_grad_x:
        grad_x = conv_ops.conv_grad_x(
            delta, w, z_star=z_star, alpha_inv=alpha_inv, backend=backend,
            conv_mode=conv_mode, tiles=tiles,
        )
    return grad_x, grad_w


def linear_weight_update(
    x: torch.Tensor,
    w: torch.Tensor,
    delta: torch.Tensor,
    opt_state: opt.IntegerSGDState,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    fuse_bwd: bool = True,
    backend: str = "auto",
    tiles: TileConfig | None = None,
    need_grad_x: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """IntegerLinear backward + optimiser: ``(grad_x, w_new)``.

    The fused path runs ``grad_w_opt_matmul`` beside ``grad_x_matmul``;
    the escape hatches return ``linear_grads``' grad_x beside
    ``apply_update(w, grad_w)``.
    """
    if z_star is None or not fuse_bwd:
        grad_x, grad_w = linear_grads(
            x, w, delta, z_star=z_star, alpha_inv=alpha_inv,
            fuse_bwd=fuse_bwd, backend=backend, tiles=tiles, need_grad_x=need_grad_x,
        )
        return grad_x, opt.apply_update(w, grad_w, opt_state)
    w_new = mm_ops.grad_w_opt_matmul(
        x, delta, z_star, w, opt_state.gamma_inv, opt_state.eta_inv,
        alpha_inv=alpha_inv, backend=backend, tiles=tiles,
    )
    grad_x = None
    if need_grad_x:
        grad_x = mm_ops.grad_x_matmul(delta, z_star, w, alpha_inv=alpha_inv,
                                      backend=backend, tiles=tiles)
    return grad_x, w_new


def conv_weight_update(
    x: torch.Tensor,
    w: torch.Tensor,
    delta: torch.Tensor,
    opt_state: opt.IntegerSGDState,
    *,
    z_star: torch.Tensor | None = None,
    alpha_inv: int = 10,
    fuse_bwd: bool = True,
    backend: str = "auto",
    conv_mode: str = "stream",
    tiles: TileConfig | None = None,
    need_grad_x: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """IntegerConv2D backward + optimiser: ``(grad_x, w_new)``.

    Stream mode applies IntegerSGD in the grad_W kernel's flush
    (``conv_grad_w_opt``) beside ``conv_grad_x``; ``fuse_bwd=False``,
    ``z_star=None`` and materialise mode (whose gradient has no flush)
    take the unfused escape hatch.
    """
    if z_star is None or not fuse_bwd or (
        conv_ops.resolve_conv_mode(conv_mode) == "materialise"
    ):
        grad_x, grad_w = conv_grads(
            x, w, delta, z_star=z_star, alpha_inv=alpha_inv,
            fuse_bwd=fuse_bwd, backend=backend, conv_mode=conv_mode,
            tiles=tiles, need_grad_x=need_grad_x,
        )
        return grad_x, opt.apply_update(w, grad_w, opt_state)
    w_new = conv_ops.conv_grad_w_opt(
        x, delta, w, opt_state.gamma_inv, opt_state.eta_inv,
        kernel_size=w.shape[0], z_star=z_star, alpha_inv=alpha_inv,
        backend=backend, conv_mode=conv_mode, tiles=tiles,
    )
    grad_x = None
    if need_grad_x:
        grad_x = conv_ops.conv_grad_x(
            delta, w, z_star=z_star, alpha_inv=alpha_inv, backend=backend,
            conv_mode=conv_mode, tiles=tiles,
        )
    return grad_x, w_new
