"""Floating-point baselines the paper compares against (Tables 1–2), the
port of ``repro.core.fp_baselines``:

  * **FP LES**  — the same local-loss block structure in float32, local MSE
    losses, SGD (Nøkland & Eidnes' algorithm restricted to the prediction
    loss, as NITRO-D uses it);
  * **FP BP**   — classic end-to-end backprop, cross-entropy + Adam.

Both reuse the ``NitroConfig`` topology so NITRO-D vs FP comparisons are
architecture-identical.  Parameters are a dict of float32 leaf tensors
shaped as the JAX tree (conv weights HWIO, linear weights (in, out)),
``{"blocks": [{"fw", "lr"}, ...], "output"}``; activations are NHWC.
Gradients come from ``torch.autograd.grad`` over the tree's leaves.

The convolutions and products are library calls (cuDNN / cuBLAS on the
card), as XLA computes them in the reference: these layers have no Pallas
kernel.  The reference computes in float32, while PyTorch lets cuDNN
convolutions use TF32 by default, which keeps 10 of float32's 23 mantissa
bits.  So the forward (``forward_fp``, ``loss_les``) and
``value_and_grad`` (the backward included, which every step takes) run
under ``full_fp32()``: it sets cuDNN's conv and cuBLAS's matmul
precision to IEEE float32 for the call and restores the caller's
settings after it, so no process-wide flag is left changed.

Randomness is ``core.prng``'s: ``init_fp_params(PRNGKey(s))`` equals the
JAX package's init bit for bit, and the dropout masks are JAX's on every
device.  cuDNN's backward need not give the same bits twice, so the card
is held to the CPU at a tolerance, never to itself bitwise.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import model as M
from repro_torch.core import prng
from repro_torch.core.blocks import BlockSpec
from repro_torch.core.numerics import INT_DTYPE, argmax_first
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.parallel.tree import leaves, tree_map, unflatten

F32 = torch.float32


@contextlib.contextmanager
def full_fp32():
    """IEEE float32 for cuDNN convolutions and cuBLAS matmuls (no TF32)
    inside the block; the caller's settings come back after it.  Through
    the per-op ``fp32_precision`` settings: writing the legacy
    ``allow_tf32`` flags beside them makes later reads of those raise."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = conv.fp32_precision, mm.fp32_precision
    conv.fp32_precision = mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = saved


def _fp32(fn):
    """Run ``fn`` under ``full_fp32()``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_fp32():
            return fn(*args, **kwargs)
    return wrapper


# ---------------------------------------------------------------------------
# Float forward pieces
# ---------------------------------------------------------------------------


def _conv(x, w):
    """NHWC × HWIO → NHWC, stride 1, 'SAME' padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding="same")
    return y.permute(0, 2, 3, 1)


def _maxpool(x):
    """2×2 max pool, stride 2, 'VALID' (an odd edge is dropped)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _avgpool_to(x, target):
    n, h, w, c = x.shape
    s = max(math.isqrt(max(target // c, 1)), 1)
    s = min(s, h, w)
    win = h // s
    xs = x[:, : s * win, : s * win, :].reshape(n, s, win, s, win, c)
    return xs.mean(dim=(2, 4)).reshape(n, -1)


def _leaky(x, alpha=0.1):
    # torch.where, not F.leaky_relu: the gradient at x = 0 is 1, as
    # jnp.where(x >= 0, ...) gives it (leaky_relu's backward gives alpha)
    return torch.where(x >= 0, x, alpha * x)


def init_fp_params(key: torch.Tensor, cfg: M.NitroConfig, *,
                   device=DEFAULT_DEVICE) -> dict:
    """He-uniform float init mirroring the integer topology: the JAX
    package's ``init_fp_params`` bit for bit (same key tree, same draws)."""
    device = resolve_device(device)
    keys = prng.split(key, cfg.num_blocks + 1)
    params: dict = {"blocks": [], "output": None}
    shape = cfg.input_shape

    def he(k, shp, fan_in):
        b = math.sqrt(3.0) / math.sqrt(fan_in)
        return prng.uniform(k, shp, -b, b, device=device)

    for spec, k in zip(cfg.blocks, keys[:-1]):
        kf, kl = prng.split(k)
        if spec.kind == "conv":
            h, w, c = shape
            fan = spec.kernel_size ** 2 * c
            fw = he(kf, (spec.kernel_size, spec.kernel_size, c, spec.out_features), fan)
            oh, ow = (h // 2, w // 2) if spec.pool else (h, w)
            shape = (oh, ow, spec.out_features)
            dummy = torch.zeros((1, oh, ow, spec.out_features), dtype=F32)
            lr_in = _avgpool_to(dummy, spec.d_lr).shape[-1]
        else:
            m = math.prod(shape)  # linear blocks flatten whatever precedes them
            fw = he(kf, (m, spec.out_features), m)
            shape = (spec.out_features,)
            lr_in = spec.out_features
        lr = he(kl, (lr_in, cfg.num_classes), lr_in)
        params["blocks"].append({"fw": fw, "lr": lr})
    feat = math.prod(shape)
    params["output"] = he(keys[-1], (feat, cfg.num_classes), feat)
    return params


def fp_params_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> dict:
    """Carry a JAX FP parameter tree (as numpy arrays) across to the port:
    the same structure of float32 tensors on ``device``."""
    device = resolve_device(device)

    def conv(a):
        arr = np.asarray(a)
        if arr.dtype != np.float32:
            raise TypeError(f"FP parameter must be float32, got {arr.dtype}")
        return torch.from_numpy(arr.copy()).to(device)

    return {"blocks": [{"fw": conv(b["fw"]), "lr": conv(b["lr"])} for b in tree["blocks"]],
            "output": conv(tree["output"])}


def _block_forward(spec: BlockSpec, p: dict, a, *, key, train):
    if spec.kind == "conv":
        z = _conv(a, p["fw"])
    else:
        if a.ndim > 2:
            a = a.reshape(a.shape[0], -1)
        z = a @ p["fw"]
    a = _leaky(z)
    if spec.pool:
        a = _maxpool(a)
    if train and spec.dropout > 0.0 and key is not None:
        keep = 1.0 - spec.dropout
        mask = prng.bernoulli(key, keep, a.shape, device=a.device)
        # multiply, then divide, by a device tensor: a divisor that is a
        # CPU scalar becomes a multiply by its reciprocal on CUDA
        a = a * mask.to(F32) / torch.tensor(keep, dtype=F32, device=a.device)
    return a


def _local_head(spec: BlockSpec, p: dict, a):
    feats = _avgpool_to(a, spec.d_lr) if spec.kind == "conv" else a
    return feats @ p["lr"]


def _input(params, x) -> torch.Tensor:
    return torch.as_tensor(x).to(device=params["output"].device, dtype=F32)


@_fp32
def forward_fp(params, cfg: M.NitroConfig, x, *, train=False, key=None):
    """Float forward; returns (logits, per-block (spec, params, activation))."""
    a = _input(params, x)
    keys = (
        list(prng.split(key, cfg.num_blocks))
        if (train and key is not None)
        else [None] * cfg.num_blocks
    )
    locals_ = []
    for spec, p, dk in zip(cfg.blocks, params["blocks"], keys):
        a = _block_forward(spec, p, a, key=dk, train=train)
        locals_.append((spec, p, a))
    flat = a.reshape(a.shape[0], -1)
    logits = flat @ params["output"]
    return logits, locals_


def _labels(labels, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(labels).to(device=like.device, dtype=torch.int64)


def _xent(logits, labels):
    logz = F.log_softmax(logits, dim=-1)
    return -torch.mean(logz.gather(1, _labels(labels, logits)[:, None]))


def _mse_local(yl, labels, num_classes):
    y = F.one_hot(_labels(labels, yl), num_classes).to(F32)
    return torch.mean((yl - y) ** 2)


def loss_bp(params, cfg, x, labels, key):
    logits, _ = forward_fp(params, cfg, x, train=True, key=key)
    return _xent(logits, labels)


@_fp32
def loss_les(params, cfg, x, labels, key):
    """LES: Σ local losses with stop-gradient between blocks + output loss."""
    a = _input(params, x)
    keys = list(prng.split(key, cfg.num_blocks))
    total = 0.0
    for spec, p, dk in zip(cfg.blocks, params["blocks"], keys):
        a = _block_forward(spec, p, a, key=dk, train=True)
        total = total + _mse_local(_local_head(spec, p, a), labels, cfg.num_classes)
        a = a.detach()  # confine gradients to the block
    flat = a.reshape(a.shape[0], -1)
    total = total + _xent(flat @ params["output"], labels)
    return total


@_fp32
def value_and_grad(loss_fn, params, cfg, x, labels, key):
    """``jax.value_and_grad(loss_fn)`` over the params tree: (loss, grads).

    A leaf the loss does not reach (the ``lr`` heads under FP BP) gets a
    zero gradient, as JAX's grad gives it, so the optimiser keeps every
    leaf.
    """
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = loss_fn(unflatten(params, flat), cfg, x, labels, key)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


# ---------------------------------------------------------------------------
# Adam (the reference's own 20-line implementation)
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor  # int32 scalar


def adam_init(params) -> AdamState:
    z = tree_map(torch.zeros_like, params)
    return AdamState(mu=z, nu=tree_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=INT_DTYPE,
                                       device=params["output"].device))


def adam_state_from_numpy(state, device=DEFAULT_DEVICE) -> AdamState:
    """Carry a JAX ``AdamState`` (its fields as numpy) across to the port."""
    device = resolve_device(device)
    count = np.asarray(state[2])
    if count.dtype != np.int32:
        raise TypeError(f"Adam count must be int32, got {count.dtype}")
    return AdamState(mu=fp_params_from_numpy(state[0], device),
                     nu=fp_params_from_numpy(state[1], device),
                     count=torch.from_numpy(count.copy()).to(device))


def adam_update(params, grads, state: AdamState, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    count = state.count + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    t = count.to(F32)
    # float32 powers, as JAX's b ** t on a float32 t
    c1 = 1 - torch.tensor(b1, dtype=F32, device=t.device) ** t
    c2 = 1 - torch.tensor(b2, dtype=F32, device=t.device) ** t

    def upd(p, m, v):
        mhat = m / c1
        vhat = v / c2
        return p - lr * mhat / (torch.sqrt(vhat) + eps)
    return tree_map(upd, params, mu, nu), AdamState(mu, nu, count)


def sgd_update(params, grads, lr=5e-4):
    return tree_map(lambda p, g: p - lr * g, params, grads)


def train_step_bp(params, opt_state, cfg, x, labels, key, lr=1e-3):
    loss, grads = value_and_grad(loss_bp, params, cfg, x, labels, key)
    params, opt_state = adam_update(params, grads, opt_state, lr=lr)
    return params, opt_state, loss


def train_step_les(params, cfg, x, labels, key, lr=5e-4):
    loss, grads = value_and_grad(loss_les, params, cfg, x, labels, key)
    return sgd_update(params, grads, lr=lr), loss


@torch.no_grad()
def accuracy_fp(params, cfg, x, labels):
    """Correct top-1 predictions (int32), first maximum on ties."""
    logits, _ = forward_fp(params, cfg, x, train=False)
    hit = argmax_first(logits, -1) == _labels(labels, logits)
    return hit.sum().to(INT_DTYPE)
