"""RWKV6 ("Finch") layer: attention-free token mixing with data-dependent
per-channel decay, plus squared-ReLU channel mixing (port of
``repro.models.rwkv``).

Semantics (per head, key/value dims D)::

    out_t = r_tᵀ ( S_{t-1} + diag(u) k_t v_tᵀ )
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ          w_t ∈ (0,1) data-dependent

computed in the chunked form (chunk 64) so the intra-chunk work is
matmuls; with L_t = Σ_{u≤t} log w_u (chunk-local, per channel)::

    inter :  out_t += (r_t ⊙ e^{L_{t-1}})ᵀ S₀
    intra :  M_{ts} = (r_t ⊙ e^{L_{t-1}}) · (k_s ⊙ e^{-L_s}),  s < t
    bonus :  out_t += (r_t ⊙ u · k_t) v_t
    state :  S_C = diag(e^{L_C}) S₀ + (k ⊙ e^{L_C - L})ᵀ v

The state is carried across chunks by a loop (JAX's ``lax.scan``).  Decode
runs the naive recurrence (C = 1) on one token against the state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.config import ModelConfig

CHUNK = 64
DECAY_LORA = 64
MIN_LOG_W = -8.0


class RwkvState(NamedTuple):
    s: torch.Tensor          # (B, H, Dk, Dv) wkv state
    x_prev_tm: torch.Tensor  # (B, d) last token (time-mix shift)
    x_prev_cm: torch.Tensor  # (B, d) last token (channel-mix shift)


def init_rwkv_layer(key, cfg: ModelConfig, device="cpu") -> dict:
    d, f = cfg.d_model, cfg.d_ff
    ks = prng.split(key, 12)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln1": torch.zeros((d,), **f32),
        "ln2": torch.zeros((d,), **f32),
        # time-mix lerp coefficients for (r, k, v, g, w)
        "mu": 0.5 * torch.ones((5, d), **f32),
        "wr": dense_init(ks[0], (d, d), d, device=device),
        "wk": dense_init(ks[1], (d, d), d, device=device),
        "wv": dense_init(ks[2], (d, d), d, device=device),
        "wg": dense_init(ks[3], (d, d), d, device=device),
        "wo": dense_init(ks[4], (d, d), d, device=device),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((d,), -2.0, **f32),
        "wA": dense_init(ks[5], (d, DECAY_LORA), d, device=device),
        "wB": dense_init(ks[6], (DECAY_LORA, d), DECAY_LORA, device=device) * 0.1,
        "u": torch.zeros((d,), **f32),      # current-token bonus
        "ln_head": torch.zeros((d,), **f32),
        # channel mix
        "mu_cm": 0.5 * torch.ones((2, d), **f32),
        "cm_k": dense_init(ks[7], (d, f), d, device=device),
        "cm_v": dense_init(ks[8], (f, d), f, device=device),
        "cm_r": dense_init(ks[9], (d, d), d, device=device),
    }


def rwkv_logical_axes(cfg: ModelConfig) -> dict:
    return {
        "ln1": (None,), "ln2": (None,),
        "mu": (None, None),
        "wr": ("p_fsdp", "p_rnn"), "wk": ("p_fsdp", "p_rnn"),
        "wv": ("p_fsdp", "p_rnn"), "wg": ("p_fsdp", "p_rnn"),
        "wo": ("p_rnn", "p_fsdp"),
        "w0": ("p_rnn",), "wA": ("p_fsdp", None), "wB": (None, "p_rnn"),
        "u": ("p_rnn",), "ln_head": (None,),
        "mu_cm": (None, None),
        "cm_k": ("p_fsdp", "p_mlp"), "cm_v": ("p_mlp", "p_fsdp"),
        "cm_r": ("p_fsdp", "p_rnn"),
    }


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: (B,S,d) rolled right by one, front-filled from state."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _mix(x, x_shift, mu):
    return x + (x_shift - x) * mu


def _decay_log_w(p, xw: torch.Tensor) -> torch.Tensor:
    """log w_t ∈ [MIN_LOG_W, 0): w = exp(-exp(w0 + tanh(x A) B))."""
    f32 = torch.float32
    lw = -torch.exp(p["w0"].to(f32)
                    + torch.tanh(xw.to(f32) @ p["wA"].to(f32)) @ p["wB"].to(f32))
    return torch.clamp(lw, MIN_LOG_W, -1e-6)


def _wkv_chunk(s0, r, k, v, lw, u):
    """One chunk of the GLA recurrence.  All (B,H,C,D) fp32."""
    lcum = torch.cumsum(lw, dim=2)                 # L_t, inclusive
    l_prev = lcum - lw                             # L_{t-1}
    r_t = r * torch.exp(l_prev)
    k_t = k * torch.exp(-lcum)
    # intra-chunk: strictly lower-triangular attention matrix
    m = torch.einsum("bhtd,bhsd->bhts", r_t, k_t)
    c = r.shape[2]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    m = torch.where(tri, m, torch.zeros((), dtype=m.dtype, device=m.device))
    out = torch.einsum("bhts,bhsv->bhtv", m, v)
    # inter-chunk: contribution of the incoming state
    out = out + torch.einsum("bhtd,bhdv->bhtv", r_t, s0)
    # current-token bonus (diagonal)
    out = out + (r * u * k).sum(-1, keepdim=True) * v
    # state update
    l_tot = lcum[:, :, -1:, :]                     # L_C
    s_new = s0 * torch.exp(l_tot.squeeze(2))[..., None] + torch.einsum(
        "bhsd,bhsv->bhdv", k * torch.exp(l_tot - lcum), v)
    return s_new, out


def rwkv_time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, state: RwkvState
                  ) -> tuple[torch.Tensor, RwkvState]:
    """Token mixing over a full sequence (training), chunked."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xs = _shift(x, state.x_prev_tm)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (_mix(x, xs, mu[i]) for i in range(5))

    r = (xr @ p["wr"].to(x.dtype)).to(torch.float32).reshape(b, s, h, hd)
    k = (xk @ p["wk"].to(x.dtype)).to(torch.float32).reshape(b, s, h, hd)
    v = (xv @ p["wv"].to(x.dtype)).to(torch.float32).reshape(b, s, h, hd)
    g = F.silu((xg @ p["wg"].to(x.dtype)).to(torch.float32))
    lw = _decay_log_w(p, xw).reshape(b, s, h, hd)
    u = p["u"].to(torch.float32).reshape(1, h, 1, hd)

    # (B,S,H,D) → (B,H,S,D), chunked over S
    r, k, v, lw = (t.movedim(2, 1) for t in (r, k, v, lw))
    n_chunks = max(s // CHUNK, 1)
    ck = s // n_chunks
    s_state = state.s
    outs = []
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        s_state, o = _wkv_chunk(s_state, r[:, :, sl], k[:, :, sl], v[:, :, sl],
                                lw[:, :, sl], u)
        outs.append(o)
    out = torch.cat(outs, dim=2)                     # (B,H,S,D)
    out = out.movedim(1, 2).reshape(b, s, d)

    # per-head groupnorm, output gate, projection
    out = rms_norm(out.reshape(b, s, h, hd),
                   torch.zeros((hd,), dtype=torch.float32, device=x.device)).reshape(b, s, d)
    out = out * (1.0 + p["ln_head"].to(torch.float32))
    out = (out * g).to(x.dtype) @ p["wo"].to(x.dtype)
    return out, RwkvState(s=s_state, x_prev_tm=x[:, -1, :], x_prev_cm=state.x_prev_cm)


def rwkv_time_mix_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: RwkvState
                         ) -> tuple[torch.Tensor, RwkvState]:
    """Single-token recurrence (the naive form — C = 1).  x: (B, d)."""
    b, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xs = state.x_prev_tm
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (_mix(x, xs, mu[i]) for i in range(5))

    f32 = torch.float32
    r = (xr @ p["wr"].to(x.dtype)).to(f32).reshape(b, h, hd)
    k = (xk @ p["wk"].to(x.dtype)).to(f32).reshape(b, h, hd)
    v = (xv @ p["wv"].to(x.dtype)).to(f32).reshape(b, h, hd)
    g = F.silu((xg @ p["wg"].to(x.dtype)).to(f32))
    w = torch.exp(_decay_log_w(p, xw)).reshape(b, h, hd)
    u = p["u"].to(f32).reshape(1, h, hd)

    kv = torch.einsum("bhd,bhv->bhdv", k, v)
    out = torch.einsum("bhd,bhdv->bhv", r, state.s + u[..., None] * kv)
    s_new = state.s * w[..., None] + kv
    out = rms_norm(out.reshape(b, 1, h, hd),
                   torch.zeros((hd,), dtype=f32, device=x.device)).reshape(b, 1, d)
    out = out * (1.0 + p["ln_head"].to(f32))
    out = (out * g[:, None, :]).to(x.dtype) @ p["wo"].to(x.dtype)
    return out[:, 0], RwkvState(s=s_new, x_prev_tm=x, x_prev_cm=state.x_prev_cm)


def rwkv_channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, state: RwkvState, *,
                     decode: bool = False) -> tuple[torch.Tensor, RwkvState]:
    if decode:
        xs, new_prev = state.x_prev_cm, x
    else:
        xs, new_prev = _shift(x, state.x_prev_cm), x[:, -1, :]
    mu = p["mu_cm"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(F.relu(xk @ p["cm_k"].to(x.dtype)))
    r = torch.sigmoid(xr @ p["cm_r"].to(x.dtype))
    out = r * (k @ p["cm_v"].to(x.dtype))
    return out, RwkvState(s=state.s, x_prev_tm=state.x_prev_tm, x_prev_cm=new_prev)


def init_rwkv_state(cfg: ModelConfig, batch: int, device="cpu") -> RwkvState:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    return RwkvState(
        s=torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        x_prev_tm=torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
        x_prev_cm=torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
    )


def rwkv_layer(p: dict, cfg: ModelConfig, x: torch.Tensor, state: RwkvState, *,
               decode: bool = False) -> tuple[torch.Tensor, RwkvState]:
    """Full RWKV6 block: time-mix + channel-mix with pre-norms.
    ``decode``: x is one token (B, d), run against ``state``."""
    mix = rwkv_time_mix_decode if decode else rwkv_time_mix
    h, state = mix(p, cfg, rms_norm(x, p["ln1"]), state)
    x = x + h
    h, state = rwkv_channel_mix(p, cfg, rms_norm(x, p["ln2"]), state, decode=decode)
    return x + h, state
