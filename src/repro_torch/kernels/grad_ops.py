"""Backward dispatcher for the integer weight gradients and updates (port
of the part of ``repro.kernels.grad_ops`` that the LES training step
runs).

``linear_grads`` / ``conv_grads`` take the raw block gradient δ (after
the dropout/pool backwards) and, for a block's forward layers, the
cached pre-ReLU ``z_star``:

``fuse_bwd=True`` (default)
    the NITRO-ReLU derivative + scaling STE runs inside the grad_W kernel
    as δ is loaded (on the reference backend the plain version composes
    the same ops), so the masked δ is never materialised;
``fuse_bwd=False``
    the escape hatch: ``masked_delta`` materialises the masked δ, then
    plain integer matmuls run — bitwise the same.

``z_star=None`` is the learning/output layers' backward (their scaling
STE is the identity): two plain ``int_matmul``\\ s.

``linear_weight_update`` / ``conv_weight_update`` are the ``fuse_opt``
twins: they take the optimiser state and return the updated weight W′,
the IntegerSGD step running in the grad_W kernel's flush
(``grad_w_opt_matmul`` / ``conv_grad_w_opt``), so grad_W is never
written.  Their escape hatches (``z_star=None``, ``fuse_bwd=False``, and
for the conv ``conv_mode='materialise'``) compute the gradient as above
and then run ``optimizer.apply_update`` — bitwise the same.

With ``z_star`` only the weight is computed: LES confines gradients to
the block, so ``blocks.forward_layers_backward`` and
``forward_layers_update`` discard grad_x there (the JAX package computes
and drops it).  Its kernels (``*_grad_x``) come with a later slice of the
port; ``grad_x`` is returned as ``None``.
"""

from __future__ import annotations

import torch

from repro_torch.core import optimizer as opt
from repro_torch.core.numerics import int_matmul
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
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """IntegerLinear backward: ``(grad_x, grad_w)``.

    ``grad_w = xᵀ @ f(δ)``; ``grad_x = δ @ wᵀ`` only without ``z_star``
    (``None`` otherwise, see the module docstring).
    """
    if z_star is None:
        return int_matmul(delta, w.T), int_matmul(x.T, delta)
    if not fuse_bwd:
        return None, int_matmul(x.T, masked_delta(delta, z_star, alpha_inv))
    return None, mm_ops.grad_w_matmul(
        x, delta, z_star, alpha_inv=alpha_inv, backend=backend)


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
) -> tuple[None, torch.Tensor]:
    """IntegerConv2D backward: ``(None, grad_w)`` — the conv's grad_x is
    not computed on this path (see the module docstring)."""
    if z_star is not None and not fuse_bwd:
        delta = masked_delta(delta, z_star, alpha_inv)
        z_star = None
    return None, conv_ops.conv_grad_w(
        x, delta, kernel_size=w.shape[0], z_star=z_star, alpha_inv=alpha_inv,
        backend=backend, conv_mode=conv_mode,
    )


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
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """IntegerLinear backward + optimiser: ``(grad_x, w_new)``.

    The fused path runs ``grad_w_opt_matmul`` and returns ``(None, W′)``;
    the escape hatches return ``linear_grads``' grad_x beside
    ``apply_update(w, grad_w)``.
    """
    if z_star is None or not fuse_bwd:
        grad_x, grad_w = linear_grads(
            x, w, delta, z_star=z_star, alpha_inv=alpha_inv,
            fuse_bwd=fuse_bwd, backend=backend,
        )
        return grad_x, opt.apply_update(w, grad_w, opt_state)
    return None, mm_ops.grad_w_opt_matmul(
        x, delta, z_star, w, opt_state.gamma_inv, opt_state.eta_inv,
        alpha_inv=alpha_inv, backend=backend,
    )


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
) -> tuple[None, torch.Tensor]:
    """IntegerConv2D backward + optimiser: ``(None, w_new)``.

    Stream mode applies IntegerSGD in the grad_W kernel's flush
    (``conv_grad_w_opt``); ``fuse_bwd=False``, ``z_star=None`` and
    materialise mode (whose gradient has no flush) take the unfused
    escape hatch.
    """
    if z_star is None or not fuse_bwd or (
        conv_ops.resolve_conv_mode(conv_mode) == "materialise"
    ):
        grad_x, grad_w = conv_grads(
            x, w, delta, z_star=z_star, alpha_inv=alpha_inv,
            fuse_bwd=fuse_bwd, backend=backend, conv_mode=conv_mode,
        )
        return grad_x, opt.apply_update(w, grad_w, opt_state)
    return None, conv_ops.conv_grad_w_opt(
        x, delta, w, opt_state.gamma_inv, opt_state.eta_inv,
        kernel_size=w.shape[0], z_star=z_star, alpha_inv=alpha_inv,
        backend=backend, conv_mode=conv_mode,
    )
