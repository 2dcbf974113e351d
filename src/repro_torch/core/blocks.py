"""Integer local-loss blocks (port of ``repro.core.blocks``, §3.2).

Each block owns

  *forward layers*  : IntegerConv2D/IntegerLinear → NITRO Scaling →
                      NITRO-ReLU → [MaxPool2D] → [IntegerDropout]
  *learning layers* : [adaptive int avg-pool to d_lr] → flatten →
                      IntegerLinear(→ G) → NITRO Scaling   (produces ŷ_l)

Gradients are confined to the block: the local RSS gradient flows through
the learning layers and emerges as δ_l^fw at the block output, then
through the forward layers.  Nothing crosses block boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.core import activations, layers, numerics, prng, scaling
from repro_torch.core.losses import rss_grad


def _nitro_ops():
    """Lazy import of the matmul dispatcher (the kernel packages import
    ``core`` leaf modules)."""
    from repro_torch.kernels.nitro_matmul import ops

    return ops


def _conv_ops():
    """Lazy import of the conv dispatcher (same reason)."""
    from repro_torch.kernels.nitro_conv import ops

    return ops


def _pool_ops():
    """Lazy import of the max-pool dispatcher (same reason)."""
    from repro_torch.kernels.maxpool import ops

    return ops


class PoolIndexCache(NamedTuple):
    """The fused path's pool cache: each window's first-max position."""

    idx: torch.Tensor  # (N,H//2,W//2,C) uint8, di·2 + dj (``kernels.maxpool``)
    in_shape: tuple[int, int, int, int]


@dataclass(frozen=True)
class BlockSpec:
    """Static description of one integer local-loss block."""

    kind: str                 # 'conv' | 'linear'
    out_features: int         # conv filters or linear width
    pool: bool = False        # MaxPool2D(2,2) after the activation
    dropout: float = 0.0      # p_c / p_l (training only)
    d_lr: int = 4096          # learning-layer input feature budget (conv)
    alpha_inv: int = activations.DEFAULT_ALPHA_INV
    kernel_size: int = 3


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------


def init_block(
    key: torch.Tensor,
    spec: BlockSpec,
    in_shape: tuple[int, ...],
    num_classes: int,
    *,
    device="cpu",
) -> tuple[dict, tuple[int, ...]]:
    """Init one block's params; returns (params, output shape w/o batch).

    ``key`` splits into the forward-layer and learning-layer keys, as in
    the JAX package.
    """
    k_fw, k_lr = prng.split(key)
    if spec.kind == "conv":
        h, w, c = in_shape
        fw = layers.conv_init(k_fw, c, spec.out_features, spec.kernel_size,
                              device=device)
        oh, ow = (h // 2, w // 2) if spec.pool else (h, w)
        out_shape = (oh, ow, spec.out_features)
        s, _ = layers.avgpool_grid(oh, ow, spec.out_features, spec.d_lr)
        lr_in = s * s * spec.out_features
    elif spec.kind == "linear":
        m = 1
        for d in in_shape:  # linear blocks flatten whatever precedes them
            m *= d
        fw = layers.linear_init(k_fw, m, spec.out_features, device=device)
        out_shape = (spec.out_features,)
        lr_in = spec.out_features
    else:
        raise ValueError(f"unknown block kind {spec.kind!r}")
    lr = layers.linear_init(k_lr, lr_in, num_classes, device=device)
    return {"fw": fw, "lr": lr}, out_shape


# ---------------------------------------------------------------------------
# Forward layers
# ---------------------------------------------------------------------------


def forward_layers(
    params: dict,
    spec: BlockSpec,
    x: torch.Tensor,
    *,
    dropout_key: torch.Tensor | None = None,
    train: bool = True,
    fused: bool = True,
    backend: str = "auto",
    conv_mode: str = "stream",
    dp_axis=None,
    dp_shards: int = 1,
) -> tuple[torch.Tensor, dict]:
    """Run a block's forward layers; cache everything backward needs.

    ``fused=True`` runs matmul → scale → ReLU as one kernel that writes
    both ``a`` and ``z_star`` (``stream_conv_fwd`` / ``nitro_matmul_fwd``
    on CUDA tensors), then the pool through ``kernels.maxpool`` (its cache
    a ``PoolIndexCache``); ``fused=False`` is the unfused reference
    composition (``layers.maxpool_forward``'s one-hot ``PoolCache``).  The
    cache holds ``z_star``, the layer input (``conv`` or ``linear``),
    ``pool``/``dropout`` when present, and ``act``.
    ``dp_axis``/``dp_shards`` (a data-parallel rank's axis and its size)
    reach only dropout (``layers.dropout_forward``).
    """
    cache: dict[str, Any] = {}
    if spec.kind == "conv":
        sf = scaling.conv_scale_factor(spec.kernel_size, x.shape[-1])
        if fused:
            numerics.assert_int(x, "conv input")
            a, cache["z_star"] = _conv_ops().fused_conv_fwd(
                x, params["fw"]["w"], sf=sf, alpha_inv=spec.alpha_inv,
                backend=backend, conv_mode=conv_mode,
            )
            cache["conv"] = layers.ConvCache(x=x)
        else:
            z, cache["conv"] = layers.conv_forward(params["fw"], x)
    else:
        if x.ndim > 2:  # flatten conv activations entering a linear block
            x, _ = layers.flatten_forward(x)
        sf = scaling.linear_scale_factor(x.shape[-1])
        if fused:
            numerics.assert_int(x, "linear input")
            a, cache["z_star"] = _nitro_ops().fused_matmul_fwd(
                x, params["fw"]["w"], sf=sf, alpha_inv=spec.alpha_inv,
                backend=backend,
            )
            cache["linear"] = x
        else:
            z, cache["linear"] = layers.linear_forward(params["fw"], x)
    if not fused:
        z_star = scaling.scale_forward(z, sf)
        cache["z_star"] = z_star
        a = activations.nitro_relu(z_star, spec.alpha_inv)
    if spec.pool and fused:
        in_shape = tuple(a.shape)
        a, idx = _pool_ops().maxpool_fwd(a, backend=backend)
        cache["pool"] = PoolIndexCache(idx=idx, in_shape=in_shape)
    elif spec.pool:
        a, cache["pool"] = layers.maxpool_forward(a)
    if train and spec.dropout > 0.0:
        a, cache["dropout"] = layers.dropout_forward(
            dropout_key, a, spec.dropout, dp_axis=dp_axis, dp_shards=dp_shards)
    cache["act"] = a
    return a, cache


def forward_layers_delta(cache: dict, delta_fw: torch.Tensor, *,
                         backend: str = "auto") -> torch.Tensor:
    """δ_l^fw back through the dropout and pool backwards: the gradient at
    the forward layer's pre-activation output.  The pool's backward follows
    its cache: ``kernels.maxpool`` for the fused path's ``PoolIndexCache``
    (``backend`` as its dispatcher takes it), ``layers.maxpool_backward``
    for the one-hot."""
    g = delta_fw
    if "dropout" in cache:
        g = layers.dropout_backward(cache["dropout"], g)
    pool = cache.get("pool")
    if isinstance(pool, PoolIndexCache):
        g = _pool_ops().maxpool_bwd(g, pool.idx, pool.in_shape, backend=backend)
    elif pool is not None:
        g = layers.maxpool_backward(pool, g)
    return g


def forward_layers_backward(
    params: dict,
    spec: BlockSpec,
    cache: dict,
    delta_fw: torch.Tensor,
    *,
    conv_mode: str = "stream",
    backend: str = "auto",
    fuse_bwd: bool = True,
) -> dict:
    """Backward through the forward layers from δ_l^fw; returns the weight
    gradients.  Dropout and pool backwards as ``forward_layers_delta``
    routes them; the NITRO-ReLU derivative runs inside the grad_W kernel
    (``fuse_bwd=True``) or as a materialised mask (``False``), bitwise the
    same.

    The layer's input gradient is not computed (``need_grad_x=False``):
    LES confines gradients to the block, so the JAX step discards it and
    XLA removes its kernels from the compiled step; here no ``*_grad_x``
    kernel is launched either.
    """
    g = forward_layers_delta(cache, delta_fw, backend=backend)
    if spec.kind == "conv":
        _, grads = layers.conv_backward(
            params["fw"], cache["conv"], g,
            z_star=cache["z_star"], alpha_inv=spec.alpha_inv,
            fuse_bwd=fuse_bwd, conv_mode=conv_mode, backend=backend,
            need_grad_x=False,
        )
    else:
        _, grads = layers.linear_backward(
            params["fw"], cache["linear"], g,
            z_star=cache["z_star"], alpha_inv=spec.alpha_inv,
            fuse_bwd=fuse_bwd, backend=backend, need_grad_x=False,
        )
    return grads


def forward_layers_update(
    params: dict,
    spec: BlockSpec,
    cache: dict,
    delta_fw: torch.Tensor,
    opt_state,
    *,
    conv_mode: str = "stream",
    backend: str = "auto",
    fuse_bwd: bool = True,
) -> dict:
    """``forward_layers_backward`` + IntegerSGD: returns the updated fw
    params.  The same dropout/pool backwards, then the weight gradient is
    consumed where it is produced: the IntegerSGD step runs in the grad_W
    kernel's flush (``layers.conv_update`` / ``linear_update``), so grad_W
    is never written.  Bitwise backward then ``optimizer.apply_tree``.
    The input gradient is not computed, as in ``forward_layers_backward``.
    """
    g = forward_layers_delta(cache, delta_fw, backend=backend)
    if spec.kind == "conv":
        _, new_fw = layers.conv_update(
            params["fw"], cache["conv"], g, opt_state,
            z_star=cache["z_star"], alpha_inv=spec.alpha_inv,
            fuse_bwd=fuse_bwd, conv_mode=conv_mode, backend=backend,
            need_grad_x=False,
        )
    else:
        _, new_fw = layers.linear_update(
            params["fw"], cache["linear"], g, opt_state,
            z_star=cache["z_star"], alpha_inv=spec.alpha_inv,
            fuse_bwd=fuse_bwd, backend=backend, need_grad_x=False,
        )
    return new_fw


# ---------------------------------------------------------------------------
# Learning layers
# ---------------------------------------------------------------------------


def learning_layers(
    params: dict, spec: BlockSpec, a: torch.Tensor
) -> tuple[torch.Tensor, dict]:
    """ŷ_l = scale(pool·flatten(a_l) @ W^il); returns the local prediction."""
    cache: dict[str, Any] = {}
    if spec.kind == "conv":
        a, cache["avgpool"] = layers.avgpool_to(a, spec.d_lr)
        a, cache["flat_shape"] = layers.flatten_forward(a)
    z, cache["linear"] = layers.linear_forward(params["lr"], a)
    y_hat = scaling.scale_forward(z, scaling.linear_scale_factor(a.shape[-1]))
    return y_hat, cache


def learning_layers_backward(
    params: dict, spec: BlockSpec, cache: dict, grad_loss: torch.Tensor
) -> tuple[torch.Tensor, dict]:
    """Backward from ∇L_l; returns (δ_l^fw at the block output, lr grads)."""
    g = scaling.scale_backward(grad_loss)  # STE through the output scaling
    g, grads = layers.linear_backward(params["lr"], cache["linear"], g)
    if spec.kind == "conv":
        g = layers.flatten_backward(cache["flat_shape"], g)
        g = layers.avgpool_to_backward(cache["avgpool"], g)
    return g, grads


# ---------------------------------------------------------------------------
# Output layers (final classifier — trained with the global RSS gradient)
# ---------------------------------------------------------------------------


def init_output(key: torch.Tensor, in_features: int, num_classes: int,
                *, device="cpu") -> dict:
    return layers.linear_init(key, in_features, num_classes, device=device)


def output_forward(params: dict, a: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Output layers: flatten → IntegerLinear → NITRO Scaling (no ReLU)."""
    cache: dict[str, Any] = {}
    if a.ndim > 2:
        a, cache["flat_shape"] = layers.flatten_forward(a)
    z, cache["linear"] = layers.linear_forward(params, a)
    return scaling.scale_forward(z, scaling.linear_scale_factor(a.shape[-1])), cache


def output_backward(params: dict, cache: dict, grad_loss: torch.Tensor) -> dict:
    """The output layer's weight gradient; its input gradient leaves the
    model, so it is not computed (the JAX step discards it too)."""
    g = scaling.scale_backward(grad_loss)
    _, grads = layers.linear_backward(params, cache["linear"], g,
                                      need_grad_x=False)
    return grads


def local_gradient(y_hat: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """∇L_l = ŷ_l − y (RSS)."""
    return rss_grad(y_hat, y_onehot)
