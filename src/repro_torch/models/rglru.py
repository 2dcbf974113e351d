"""RG-LRU recurrent block, RecurrentGemma / Griffin (port of
``repro.models.rglru``).

    i_t = σ(x_t W_x + b_x)                      (input gate)
    r_t = σ(x_t W_a + b_a)                      (recurrence gate)
    a_t = exp(-c · r_t · softplus(Λ))           (data-dependent decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates use block-diagonal weights with 16 blocks.  The sequence
recurrence is a log-depth inclusive scan (``rglru_scan``), JAX's
``lax.associative_scan`` with the same combine; torch has none, so it is
written as a Hillis–Steele scan, whose products associate in another tree
than JAX's: equal in exact arithmetic, within float32 rounding otherwise
(``tests/test_torch_lm_models.py`` states the tolerance).  Decode runs one
gate step (``rglru_step``) on the width-4 conv over the cached tail.

Full recurrent block (Griffin layout): y = W_out( GeLU(x W_g) ⊙
RG-LRU(conv1d₄(x W_in)) ).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.config import ModelConfig

N_GATE_BLOCKS = 16
RGLRU_C = 8.0
CONV_WIDTH = 4


class RglruState(NamedTuple):
    h: torch.Tensor       # (B, W) recurrent state
    conv: torch.Tensor    # (B, CONV_WIDTH-1, W) conv1d tail


def init_rglru_layer(key, cfg: ModelConfig, device="cpu") -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    bw = w // N_GATE_BLOCKS
    ks = prng.split(key, 6)
    return {
        "ln": torch.zeros((d,), dtype=torch.float32, device=device),
        "w_in": dense_init(ks[0], (d, w), d, device=device),
        "w_gate": dense_init(ks[1], (d, w), d, device=device),
        "w_out": dense_init(ks[2], (w, d), w, device=device),
        "conv_w": dense_init(ks[3], (CONV_WIDTH, w), CONV_WIDTH, device=device),
        # block-diagonal input/recurrence gates: (blocks, bw, bw)
        "gate_x": dense_init(ks[4], (N_GATE_BLOCKS, bw, bw), bw, device=device),
        "gate_a": dense_init(ks[5], (N_GATE_BLOCKS, bw, bw), bw, device=device),
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=device),
    }


def rglru_logical_axes(cfg: ModelConfig) -> dict:
    return {
        "ln": (None,),
        "w_in": ("p_fsdp", "p_rnn"),
        "w_gate": ("p_fsdp", "p_rnn"),
        "w_out": ("p_rnn", "p_fsdp"),
        "conv_w": (None, "p_rnn"),
        "gate_x": ("p_rnn_block", None, None),
        "gate_a": ("p_rnn_block", None, None),
        "lam": ("p_rnn",),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., W) → (..., W) through (blocks, bw, bw) block-diagonal w."""
    shape = x.shape
    b = w.shape[0]
    xb = x.reshape(*shape[:-1], b, shape[-1] // b)
    return torch.einsum("...bi,bij->...bj", xb, w.to(x.dtype)).reshape(shape)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gates(p, x):
    i_t = torch.sigmoid(_block_diag(x, p["gate_x"]).to(torch.float32))
    r_t = torch.sigmoid(_block_diag(x, p["gate_a"]).to(torch.float32))
    log_a = -RGLRU_C * r_t * _softplus(p["lam"].to(torch.float32))
    a_t = torch.exp(log_a)
    # √(1−a²) via log-space for stability at a → 1
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a_t, beta * i_t * x.to(torch.float32)


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t (h_{-1} = 0) along ``dim``, as a log-depth
    inclusive scan of the combine (a_l, b_l) ∘ (a_r, b_r) = (a_l·a_r,
    b_l·a_r + b_r)."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_prev, b_prev = a.narrow(dim, 0, n - d), b.narrow(dim, 0, n - d)
        a_cur, b_cur = a.narrow(dim, d, n - d), b.narrow(dim, d, n - d)
        b = torch.cat([b.narrow(dim, 0, d), b_prev * a_cur + b_cur], dim=dim)
        a = torch.cat([a.narrow(dim, 0, d), a_prev * a_cur], dim=dim)
        d *= 2
    return b


def rglru_scan(p, x: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence recurrence via a log-depth scan.  x: (B,S,W) → (B,S,W)."""
    a, b = _gates(p, x)                     # (B,S,W) fp32
    # fold the incoming state into the first step
    first = b[:, :1, :] + a[:, :1, :] * h0.to(torch.float32)[:, None, :]
    b = torch.cat([first, b[:, 1:, :]], dim=1)
    h = linear_scan(a, b, dim=1)
    return h.to(x.dtype), h[:, -1, :]


def rglru_step(p, x: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  x: (B,W)."""
    a, b = _gates(p, x[:, None, :])
    h = a[:, 0] * h0.to(torch.float32) + b[:, 0]
    return h.to(x.dtype), h


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d (width 4).  x: (B,S,W), tail: (B,3,W)."""
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = 0
    for i in range(CONV_WIDTH):
        out = out + xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
    return out, xp[:, -(CONV_WIDTH - 1):, :]


def rglru_block(p: dict, cfg: ModelConfig, x: torch.Tensor, state: RglruState, *,
                decode: bool = False) -> tuple[torch.Tensor, RglruState]:
    """Full Griffin recurrent block (pre-norm, residual added by caller).
    ``decode``: x is one token (B, d), run against ``state``."""
    xn = rms_norm(x[:, None, :] if decode else x, p["ln"])
    gate = F.gelu(xn @ p["w_gate"].to(xn.dtype), approximate="tanh")
    u = xn @ p["w_in"].to(xn.dtype)
    if decode:
        conv_in = torch.cat([state.conv.to(u.dtype), u], dim=1)
        u_c = 0
        for i in range(CONV_WIDTH):
            u_c = u_c + conv_in[:, i, :] * p["conv_w"][i].to(u.dtype)
        h, h_last = rglru_step(p, u_c, state.h)
        y = h * gate[:, 0]
        return y @ p["w_out"].to(y.dtype), RglruState(h=h_last, conv=conv_in[:, 1:, :])
    u_c, new_tail = _causal_conv(u, p["conv_w"], state.conv)
    h, h_last = rglru_scan(p, u_c, state.h)
    y = h * gate
    out = y @ p["w_out"].to(y.dtype)
    return out, RglruState(h=h_last, conv=new_tail)


def init_rglru_state(cfg: ModelConfig, batch: int, device="cpu") -> RglruState:
    w = cfg.lru_width or cfg.d_model
    return RglruState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_WIDTH - 1, w), dtype=torch.bfloat16, device=device),
    )
