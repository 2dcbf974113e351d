"""Dense MLP (SwiGLU/GeLU) and sort-free capacity-based MoE (port of
``repro.models.mlp``).

MoE uses the scatter/gather dispatch (position in expert via a one-hot
cumsum): tokens are placed into an (E, C, d) buffer, the experts run as one
batched matmul, and the results are combined with the router's top-k
weights.  Tokens beyond an expert's capacity are dropped: their scatter
lands on a trash row, and the combine gives them zero.  One device: the
capacity is the no-mesh formula, which equals the mesh formula at one
batch shard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.common import dense_init, matmul
from repro_torch.models.config import ModelConfig

CAPACITY_FACTOR = 1.25


def init_mlp(key, cfg: ModelConfig, device="cpu") -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.moe is not None:
        e, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        ks = prng.split(key, 4)
        p = {
            "router": dense_init(ks[0], (d, e), d, device=device),
            "wi": dense_init(ks[1], (e, d, fe), d, device=device),
            "wo": dense_init(ks[2], (e, fe, d), fe, device=device),
        }
        if cfg.mlp_type == "swiglu":
            p["wg"] = dense_init(ks[3], (e, d, fe), d, device=device)
        return p
    ks = prng.split(key, 3)
    p = {
        "wi": dense_init(ks[0], (d, f), d, device=device),
        "wo": dense_init(ks[1], (f, d), f, device=device),
    }
    if cfg.mlp_type == "swiglu":
        p["wg"] = dense_init(ks[2], (d, f), d, device=device)
    return p


def mlp_logical_axes(cfg: ModelConfig) -> dict:
    if cfg.moe is not None:
        axes = {
            "router": ("p_fsdp", None),
            "wi": ("p_expert", "p_fsdp", "p_mlp_expert"),
            "wo": ("p_expert", "p_mlp_expert", "p_fsdp"),
        }
        if cfg.mlp_type == "swiglu":
            axes["wg"] = ("p_expert", "p_fsdp", "p_mlp_expert")
        return axes
    axes = {"wi": ("p_fsdp", "p_mlp"), "wo": ("p_mlp", "p_fsdp")}
    if cfg.mlp_type == "swiglu":
        axes["wg"] = ("p_fsdp", "p_mlp")
    return axes


def _act(x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def dense_mlp(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = matmul(x, params["wi"], int8=cfg.int8_matmul)
    if cfg.mlp_type == "swiglu":
        h = _act(h, "silu") * matmul(x, params["wg"], int8=cfg.int8_matmul)
    else:
        h = _act(h, "gelu")
    return matmul(h, params["wo"], int8=cfg.int8_matmul)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``F.one_hot(idx, n).to(dtype)`` by one comparison: the same ops on
    every device (``F.one_hot`` checks its input's range on the host off
    the card, and scatters on it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _moe_local(params, cfg: ModelConfig, xt, gate_vals, expert_idx, capacity: int):
    """Dispatch → expert compute → combine over the local tokens."""
    moe = cfg.moe
    n, d = xt.shape
    flat_e = expert_idx.reshape(-1)                               # (n·k,)
    onehot = _one_hot(flat_e, moe.num_experts, torch.int32)
    pos = (torch.cumsum(onehot, 0, dtype=torch.int32) - 1) * onehot
    pos_in_e = pos.sum(-1, dtype=torch.int32)
    keep = pos_in_e < capacity

    # row scatter with a single linear index; drops → trash row
    lin = torch.where(keep, flat_e * capacity + pos_in_e,
                      torch.full_like(flat_e, moe.num_experts * capacity))
    xk = torch.repeat_interleave(xt, moe.top_k, dim=0)            # (n·k, d)
    buffer = torch.zeros((moe.num_experts * capacity + 1, d), dtype=xt.dtype,
                         device=xt.device).index_put((lin,), xk)
    buffer = buffer[:-1].reshape(moe.num_experts, capacity, d)

    h = torch.einsum("ecd,edf->ecf", buffer, params["wi"].to(xt.dtype))
    if cfg.mlp_type == "swiglu":
        g = torch.einsum("ecd,edf->ecf", buffer, params["wg"].to(xt.dtype))
        h = F.silu(h) * g
    else:
        h = _act(h, "gelu")
    y = torch.einsum("ecf,efd->ecd", h, params["wo"].to(xt.dtype))

    # combine: local row gather
    y_flat = y.reshape(moe.num_experts * capacity, d)
    gathered = y_flat[torch.where(keep, lin, torch.zeros_like(lin))]
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=gathered.dtype,
                                                                device=gathered.device))
    weighted = gathered.to(torch.float32) * gate_vals.reshape(-1)[:, None]
    return weighted.reshape(n, moe.top_k, d).sum(1).to(xt.dtype)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lowest index (a stable descending sort; ``torch.topk`` promises no tie
    order on the card)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Tokens an expert takes: ⌊1.25 · n · k / E⌋ + 1."""
    return int(CAPACITY_FACTOR * n_tokens * cfg.moe.top_k / cfg.moe.num_experts) + 1


def moe_mlp(params: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE. x: (B, S, d) → (out, aux_load_balance_loss)."""
    moe = cfg.moe
    b, s, d = x.shape
    n = b * s
    xt = x.reshape(n, d)

    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                        # (N, E)
    gate_vals, expert_idx = top_k(probs, moe.top_k)              # (N, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E · Σ_e load_e · prob_e
    onehot_n = _one_hot(expert_idx, moe.num_experts, torch.float32)
    load = onehot_n.sum((0, 1)) / (n * moe.top_k)
    imp = probs.mean(0)
    aux = moe.num_experts * (load * imp).sum()

    out = _moe_local(params, cfg, xt, gate_vals, expert_idx, moe_capacity(cfg, n))
    return out.reshape(b, s, d), aux
