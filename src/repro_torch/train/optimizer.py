"""AdamW for the LM trainer (port of ``repro.train.optimizer``): two fp32
moments per parameter, global-norm clipping and decoupled weight decay,
over the trees ``models.transformer.init_params`` builds (dicts and lists
of tensors, walked as ``parallel.tree`` walks them)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.parallel.tree import leaves, tree_map


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    leaf = leaves(params)[0]
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=leaf.device))


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in leaves(tree):
        total = total + torch.square(g.float()).sum()
    return torch.sqrt(total)


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step; returns (params, state, grad_norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    grads = tree_map(lambda g: g.float() * scale, grads)
    count = state.count + 1
    t = count.float()
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

    def upd(p, m, v):
        step = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(mu=mu, nu=nu, count=count), gnorm


def lr_schedule(step: torch.Tensor, *, peak: float, warmup: int = 200,
                total: int = 10_000) -> torch.Tensor:
    """Linear warmup → cosine decay (lr = 0 at step 0)."""
    s = step.float()
    warm = peak * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)
