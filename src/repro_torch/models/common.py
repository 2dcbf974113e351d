"""Shared model components: norms, RoPE/M-RoPE, initialisers, int8 matmul
(port of ``repro.models.common``).

The ``int8_matmul`` path is the NITRO-numerics adaptation for LM matmuls:
activations are brought to the int8 operational range with a static
power-of-two scale (2⁶, the paper's σ=64 operating point) and weights are
stored int8 against a power-of-two scale frozen at the call, so the
de-scale is a shift.  The int8 × int8 → int32 product is
``numerics.int_matmul``: on the card the hand-written integer GEMM
(``kernels/int_matmul``), whose route W (wgmma fed by TMA) reads the
K-major int8 weight as it lies.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.numerics import int_matmul


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (qwen3): normalise the trailing head_dim."""
    return rms_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D), positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                 # (D/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)         # (..., S, D/2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): the D/2 frequency slots are split into
    (t, h, w) sections, each rotated by its own position stream.

    x: (B, S, H, D);  positions: (3, B, S) integer t/h/w indices.
    """
    d_half = x.shape[-1] // 2
    assert sum(sections) == d_half, (sections, d_half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    # the slot → section map is static: built on the host, not by a
    # repeat_interleave over device repeats (a sync on the card, refused
    # on meta)
    sec_ids = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                           device=x.device)                          # (D/2,)
    pos_per_slot = positions.to(torch.float32)[sec_ids]                        # (D/2, B, S)
    return _rotate(x, pos_per_slot.movedim(0, -1) * freqs)          # (B, S, D/2)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


def dense_init(key: torch.Tensor, shape, fan_in: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """``normal(key, shape) / √fan_in``, drawn as ``jax.random.normal``."""
    scale = 1.0 / torch.sqrt(torch.tensor(fan_in, dtype=torch.float32))
    return (prng.normal(key, shape, device=device) * scale.to(device)).to(dtype)


# ---------------------------------------------------------------------------
# NITRO int8 matmul path for LM layers
# ---------------------------------------------------------------------------

ACT_SHIFT = 6  # static activation scale 2⁶ — the paper's σ=64 operating point


def quantize_weight_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantise against a power-of-two per-tensor scale frozen at call
    time: shift = ceil(log2(max|w|/127)).  Returns (int8 weights, shift).

    The int8 weight (K, N) is the view of an (N, K) row-major tensor, so
    the card's int8 GEMM reads it K-major as it lies (``int_matmul``'s
    route W); the narrowing copy writes that layout, no extra pass."""
    wf = w.to(torch.float32)
    amax = wf.abs().max()
    shift = torch.ceil(torch.log2(torch.clamp(amax / 127.0, min=1e-30)))
    wq = torch.clamp(torch.round(wf * torch.exp2(-shift)), -127, 127)
    out = torch.empty(wq.shape[::-1], dtype=torch.int8, device=wq.device).t()
    return out.copy_(wq), shift


class _Int8Matmul(torch.autograd.Function):
    """The int8 path's product with JAX's gradient: ``round`` and the
    float → int conversion pass none, so x and the weight's shift get
    explicit zeros and the graph stays whole (the weight's own zero comes
    through the shift, from ``ceil``)."""

    @staticmethod
    def forward(x, w_q, w_shift):
        xq = torch.clamp(torch.round(x.to(torch.float32) * (1 << ACT_SHIFT)), -127, 127)
        z = int_matmul(xq.to(torch.int8).reshape(-1, x.shape[-1]), w_q)
        z = z.reshape(*x.shape[:-1], w_q.shape[-1])
        return (z.to(torch.float32) * torch.exp2(w_shift - ACT_SHIFT)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x_like, s_like = ctx.saved_meta
        return (torch.zeros(x_like[0], **x_like[1]), None,
                torch.zeros(s_like[0], **s_like[1]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, _, w_shift = inputs
        ctx.saved_meta = ((x.shape, {"dtype": x.dtype, "device": x.device}),
                          (w_shift.shape, {"dtype": w_shift.dtype, "device": w_shift.device}))


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_shift: torch.Tensor) -> torch.Tensor:
    """NITRO-numerics matmul: x·2⁶ → int8, int8 × int8 → int32 through
    ``numerics.int_matmul`` (the hand-written integer GEMM on the card),
    de-scaled by the two power-of-two shifts; zero gradient, as in JAX."""
    return _Int8Matmul.apply(x, w_q, w_shift)


def matmul(x: torch.Tensor, w: torch.Tensor, *, int8: bool = False) -> torch.Tensor:
    """Project ``x`` by ``w`` in the configured numerics mode (weights are
    cast to the activation dtype — fp32 master, bf16 compute)."""
    if int8:
        w_q, w_shift = quantize_weight_int8(w)
        return int8_matmul(x, w_q, w_shift)
    return x @ w.to(x.dtype)
