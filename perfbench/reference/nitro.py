"""The plain reference of NITRO-D: the integer-only LES training step and
the frozen forward pass, in plain PyTorch, written from the paper's
equations (arXiv:2407.11698 §3, Appendices B–D).

It imports nothing of the program.  It takes the inputs the benchmark made
(weights, images, labels, dropout keys) and works out everything else
itself.  Layout is NHWC; conv weights are (K, K, C, F), linear weights
(fan_in, fan_out).  Every value is an int32 tensor and every sum wraps mod
2³², as the program's do; ⌊·⌋ is floor division.

The integer products run in one of two precisions (``prec``):

  * ``"exact"``   — the configuration's: exact int32 sums (int64 on the CPU;
    on the card float64 GEMMs over signed 16-bit limbs, each exact for a
    contraction under 2²¹);
  * ``"float32"`` — the control: float32 GEMMs with TF32 off (a 24-bit
    significand), the step from int32 accumulation to float units.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from perfbench.reference import threefry

I32 = torch.int32
ONE_HOT = 32          # Appendix B.2: the true class at 32
ACT_MIN, ACT_MAX = -127, 127
DROPOUT_BITS = 8      # inverted dropout's fixed-point denominator 2^8
ROWS_PER_BLOCK = 1 << 15  # rows of a conv's shifted GEMM per block


class Block(NamedTuple):
    kind: str          # 'conv' | 'linear'
    out: int
    pool: bool
    dropout: float
    d_lr: int
    alpha_inv: int
    k: int


class Net(NamedTuple):
    blocks: tuple
    input_shape: tuple
    num_classes: int
    gamma_inv: int     # learning and output layers
    eta_fw: int
    eta_lr: int


# ---------------------------------------------------------------------------
# Integer products
# ---------------------------------------------------------------------------


def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 → int32 keeping the low 32 bits."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(I32)


def _limbs(v: torch.Tensor):
    lo = ((v + 32768) & 0xFFFF) - 32768
    return lo, (v - lo) >> 16


def product(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """(M, K) @ (K, N) of integer tensors, unwrapped: int64 (exact mod 2³²)
    for ``exact``, float32 for ``float32``."""
    if prec == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        return a.float() @ b.float()
    a, b = a.to(torch.int64), b.to(torch.int64)
    if a.device.type == "cpu":
        return a @ b
    if a.shape[-1] >= 1 << 21:
        raise ValueError(f"contraction {a.shape[-1]} too long for exact limbs")
    al, ah = _limbs(a)
    bl, bh = _limbs(b)
    out = (al.double() @ bl.double()).to(torch.int64)
    mid = None
    if bool(ah.any()):
        mid = (ah.double() @ bl.double()).to(torch.int64)
    if bool(bh.any()):
        t = (al.double() @ bh.double()).to(torch.int64)
        mid = t if mid is None else mid + t
    if mid is not None:
        out = out + ((mid & 0xFFFF) << 16)
    return out


def _finish(v: torch.Tensor) -> torch.Tensor:
    if v.dtype.is_floating_point:
        v = v.round().to(torch.int64)
    return _wrap(v)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return _finish(product(a, b, prec))


def _chunks(n: int, rows_per_item: int):
    step = max(1, ROWS_PER_BLOCK // max(rows_per_item, 1))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def conv(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """'same' K×K conv, stride 1: z[n,h,w,f] = Σ x[n,h+i-p,w+j-p,c]·W[i,j,c,f]."""
    n, h, wd, c = x.shape
    k, f = w.shape[0], w.shape[-1]
    p = k // 2
    out = torch.empty((n, h, wd, f), dtype=I32, device=x.device)
    for s, e in _chunks(n, h * wd):
        xp = F.pad(x[s:e], (0, 0, p, p, p, p))
        acc = None
        for i in range(k):
            for j in range(k):
                part = product(xp[:, i:i + h, j:j + wd, :].reshape(-1, c), w[i, j], prec)
                acc = part if acc is None else acc + part
        out[s:e] = _finish(acc).reshape(e - s, h, wd, f)
    return out


def conv_grad_w(x: torch.Tensor, delta: torch.Tensor, k: int, prec: str) -> torch.Tensor:
    """ΣN,H,W of x's shifted patches times δ: the (K, K, C, F) weight gradient."""
    n, h, wd, c = x.shape
    f = delta.shape[-1]
    p = k // 2
    acc = [[None] * k for _ in range(k)]
    for s, e in _chunks(n, h * wd):
        xp = F.pad(x[s:e], (0, 0, p, p, p, p))
        d = delta[s:e].reshape(-1, f)
        for i in range(k):
            for j in range(k):
                part = product(xp[:, i:i + h, j:j + wd, :].reshape(-1, c).T, d, prec)
                acc[i][j] = part if acc[i][j] is None else acc[i][j] + part
    return torch.stack([torch.stack([_finish(a) for a in row]) for row in acc])


# ---------------------------------------------------------------------------
# Elementwise integer layers
# ---------------------------------------------------------------------------


def fdiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def mu_int8(alpha_inv: int) -> int:
    """μ_int8: the integer mean of NITRO-ReLU's four segment means (§3.2)."""
    return (-127 // alpha_inv + -127 // (2 * alpha_inv) + 63 + 127) // 4


def relu(z: torch.Tensor, alpha_inv: int) -> torch.Tensor:
    neg = fdiv(z.clamp(min=ACT_MIN), alpha_inv)
    return torch.where(z < 0, neg, z.clamp(max=ACT_MAX)) - mu_int8(alpha_inv)


def relu_backward(z: torch.Tensor, g: torch.Tensor, alpha_inv: int) -> torch.Tensor:
    gi = torch.where(z < 0, fdiv(g, alpha_inv), g)
    return torch.where((z < ACT_MIN) | (z > ACT_MAX), torch.zeros_like(gi), gi)


def maxpool(x: torch.Tensor):
    """2×2 stride-2 max; the gradient goes to each window's first max."""
    n, h, w, c = x.shape
    win = (x[:, :h // 2 * 2, :w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c)
           .permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4, c))
    out = win.amax(dim=3)
    is_max = win == out.unsqueeze(3)
    first = (is_max & (is_max.cumsum(dim=3) == 1)).to(I32)
    return out, first


def maxpool_backward(first: torch.Tensor, g: torch.Tensor, shape) -> torch.Tensor:
    n, h, w, c = shape
    gg = (g.unsqueeze(3) * first).reshape(n, h // 2, w // 2, 2, 2, c)
    gg = gg.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2 * 2, w // 2 * 2, c)
    return F.pad(gg, (0, 0, 0, w - w // 2 * 2, 0, h - h // 2 * 2))


def avgpool_grid(h: int, w: int, c: int, d_lr: int):
    """The learning layers' pooled grid: (s, window), s² C ≤ d_lr features."""
    s = min(max(math.isqrt(max(d_lr // c, 1)), 1), h, w)
    return s, h // s


def avgpool(x: torch.Tensor, d_lr: int) -> torch.Tensor:
    n, h, w, c = x.shape
    s, win = avgpool_grid(h, w, c, d_lr)
    xs = x[:, :s * win, :s * win].reshape(n, s, win, s, win, c)
    return fdiv(_wrap(xs.sum(dim=(2, 4), dtype=torch.int64)), win * win)


def avgpool_backward(g: torch.Tensor, shape, d_lr: int) -> torch.Tensor:
    n, h, w, c = shape
    s, win = avgpool_grid(h, w, c, d_lr)
    gg = g[:, :, None, :, None, :].expand(n, s, win, s, win, c).reshape(n, s * win, s * win, c)
    return F.pad(gg, (0, 0, 0, w - s * win, 0, h - s * win))


def dropout_mask(key: torch.Tensor, shape, rate: float, device):
    keep = 1.0 - rate
    q = int(round((1 << DROPOUT_BITS) / keep))
    threshold = min(int(keep * (1 << 32)), (1 << 32) - 1)
    return (threefry.bits(key, shape, device) < threshold).to(I32), q


def sgd(w: torch.Tensor, g: torch.Tensor, gamma_inv: int, eta_inv: int) -> torch.Tensor:
    """IntegerSGD (Algorithm 1): W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋), no decay at η = 0."""
    step = fdiv(g, gamma_inv)
    if eta_inv:
        step = step + fdiv(w, eta_inv)
    return w - step


def amplification(num_classes: int) -> int:
    """AF = 2⁶·G: the forward layers learn with γ_inv·AF."""
    return 64 * num_classes


def argmax_first(y: torch.Tensor) -> torch.Tensor:
    is_max = y == y.amax(-1, keepdim=True)
    return (is_max.cumsum(-1) == 0).sum(-1)


def rss(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = y_hat - y
    return _wrap(fdiv(d * d, 2).sum(dtype=torch.int64))


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


def _forward_layers(b: Block, w: torch.Tensor, x: torch.Tensor, key, prec: str):
    cache = {"x": x}
    if b.kind == "conv":
        z = conv(x, w, prec)
        sf = 256 * b.k * b.k * x.shape[-1]
    else:
        x = x.reshape(x.shape[0], -1)
        cache["x"] = x
        z = matmul(x, w, prec)
        sf = 256 * x.shape[-1]
    z_star = fdiv(z, sf)
    cache["z_star"] = z_star
    a = relu(z_star, b.alpha_inv)
    if b.pool:
        cache["pool_in"] = tuple(a.shape)
        a, cache["first"] = maxpool(a)
    if key is not None and b.dropout > 0.0:
        mask, q = dropout_mask(key, a.shape, b.dropout, a.device)
        cache["drop"] = (mask, q)
        a = fdiv(a * mask * q, 1 << DROPOUT_BITS)
    return a, cache


def _output(w: torch.Tensor, a: torch.Tensor, prec: str):
    a = a.reshape(a.shape[0], -1)
    return fdiv(matmul(a, w, prec), 256 * a.shape[-1]), a


def logits(net: Net, fw_weights, out_w: torch.Tensor, x: torch.Tensor, prec: str = "exact"):
    """Frozen forward: every block's forward layers, no dropout, then the
    output layers; (N, classes) int32."""
    a = x.to(I32)
    for b, w in zip(net.blocks, fw_weights):
        a, _ = _forward_layers(b, w, a, None, prec)
    return _output(out_w, a, prec)[0]


class StepOut(NamedTuple):
    params: dict
    loss: torch.Tensor
    correct: torch.Tensor
    local_losses: torch.Tensor


def train_step(net: Net, params: dict, x: torch.Tensor, labels: torch.Tensor,
               key: torch.Tensor, prec: str = "exact") -> StepOut:
    """One LES step on the batch (§3.3): forward; the output layers learn
    from the global RSS gradient; each block's learning layers from their
    local RSS gradient, whose δ reaches the block's forward layers; every
    weight updated by IntegerSGD from the step's old weights."""
    dev = params["output"]["w"].device
    x, labels = x.to(dev, I32), labels.to(dev)
    y = (labels[:, None] == torch.arange(net.num_classes, device=dev)).to(I32) * ONE_HOT
    keys = threefry.split(key, len(net.blocks))
    gamma_lr = net.gamma_inv
    gamma_fw = net.gamma_inv * amplification(net.num_classes)

    a, acts, caches = x, [], []
    for b, p, k in zip(net.blocks, params["blocks"], keys):
        a, cache = _forward_layers(b, p["fw"]["w"], a, k, prec)
        acts.append(a)
        caches.append(cache)
    w_o = params["output"]["w"]
    y_hat, a_flat = _output(w_o, a, prec)
    g_o = y_hat - y
    new_out = sgd(w_o, matmul(a_flat.T, g_o, prec), gamma_lr, net.eta_lr)

    new_blocks, local = [], []
    for b, p, a_l, cache in zip(net.blocks, params["blocks"], acts, caches):
        feat = avgpool(a_l, b.d_lr) if b.kind == "conv" else a_l
        pooled_shape = feat.shape
        feat = feat.reshape(feat.shape[0], -1)
        w_lr = p["lr"]["w"]
        y_l = fdiv(matmul(feat, w_lr, prec), 256 * feat.shape[-1])
        g_l = y_l - y
        local.append(rss(y_l, y))
        new_lr = sgd(w_lr, matmul(feat.T, g_l, prec), gamma_lr, net.eta_lr)
        delta = matmul(g_l, w_lr.T, prec)
        if b.kind == "conv":
            delta = avgpool_backward(delta.reshape(pooled_shape), a_l.shape, b.d_lr)
        if "drop" in cache:
            mask, q = cache["drop"]
            delta = fdiv(delta * mask * q, 1 << DROPOUT_BITS)
        if "first" in cache:
            delta = maxpool_backward(cache["first"], delta, cache["pool_in"])
        delta = relu_backward(cache["z_star"], delta, b.alpha_inv)
        w_fw = p["fw"]["w"]
        if b.kind == "conv":
            g_w = conv_grad_w(cache["x"], delta, b.k, prec)
        else:
            g_w = matmul(cache["x"].T, delta, prec)
        new_blocks.append({"fw": {"w": sgd(w_fw, g_w, gamma_fw, net.eta_fw)},
                           "lr": {"w": new_lr}})
    correct = (argmax_first(y_hat) == labels).sum().to(I32)
    return StepOut({"blocks": new_blocks, "output": {"w": new_out}},
                   rss(y_hat, y), correct, torch.stack(local))
