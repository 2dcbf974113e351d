"""Attention: GQA flash (blockwise, online softmax, custom backward) with
causal, triangle, sliding-window and non-causal modes, and single-token
decode attention against a (ring) KV cache (port of
``repro.models.attention``).

Plain torch ops with the JAX package's block structure, not
``scaled_dot_product_attention``: the port computes what the reference
computes.  The forward keeps float32 statistics per row (max, sum,
logsumexp); the backward (FlashAttention-2) recomputes the scores
blockwise from the saved (q, k, v, out, logsumexp), so only O(S) residuals
are kept.  Matmul inputs are rounded to bf16 (``compute_dtype='bf16'``) and
accumulated in float32, as XLA's ``preferred_element_type`` does: here the
bf16-rounded operands are multiplied in float32, which is exact for the
products and sums in float32.

Causal handling: ``masked`` computes every (q-block, kv-block) pair and
masks; ``triangle`` only the lower-triangle pairs (same output); a sliding
window visits only the kv band at the diagonal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


NEG_INF = -1e30


class FlashCfg(NamedTuple):
    causal: bool
    window: int | None
    q_block: int
    kv_block: int
    causal_mode: str
    compute_dtype: str = "bf16"   # matmul-input dtype; accumulation is fp32


def _in(cfg: FlashCfg, a: torch.Tensor) -> torch.Tensor:
    """A matmul operand rounded to the compute dtype, then held in float32
    (float32 accumulation of the rounded values)."""
    if cfg.compute_dtype == "bf16":
        return a.to(torch.bfloat16).float()
    return a.to(torch.float32)


def _scores(cfg, q_blk, k_blk):
    """(B,G,P,bq,D) × (B,G,bk,D) → (B,G,P,bq,bk), fp32 accumulation."""
    return torch.einsum("bgpqd,bgkd->bgpqk", _in(cfg, q_blk), _in(cfg, k_blk))


def _pv(cfg, p_blk, v_blk):
    """(B,G,P,bq,bk) × (B,G,bk,D) → (B,G,P,bq,D)."""
    return torch.einsum("bgpqk,bgkd->bgpqd", _in(cfg, p_blk), _in(cfg, v_blk))


def _mask_for(cfg: FlashCfg, qp, kp):
    mask = torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool, device=qp.device)
    if cfg.causal:
        mask &= qp[:, None] >= kp[None, :]
    if cfg.window is not None:
        mask &= (qp[:, None] - kp[None, :]) < cfg.window
    return mask


def _band(cfg: FlashCfg, nk: int) -> int:
    if cfg.window is None:
        return nk
    return min(nk, -(-(cfg.window - 1) // cfg.kv_block) + 1)


def _band_start(cfg: FlashCfg, qi: int, nk: int, n_band: int) -> int:
    if cfg.window is None:
        return 0
    # diagonal-aligned band (q and kv blocks may differ in size)
    diag = (qi * cfg.q_block) // cfg.kv_block
    return min(max(diag - (n_band - 1), 0), nk - n_band)


def _blocks(cfg: FlashCfg, q, k, v):
    """Scaled float32 q blocks, k / v blocks, positions and sizes."""
    b, g, p, s, d = q.shape
    s_kv = k.shape[2]
    bq, bk = min(cfg.q_block, s), min(cfg.kv_block, s_kv)
    nq, nk = s // bq, s_kv // bk
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    qf = (q.to(torch.float32) * scale).reshape(b, g, p, nq, bq, d)
    kf = k.reshape(b, g, nk, bk, d)
    vf = v.reshape(b, g, nk, bk, d)
    q_pos = torch.arange(s, device=q.device).reshape(nq, bq)
    k_pos = torch.arange(s_kv, device=q.device).reshape(nk, bk)
    return qf, kf, vf, q_pos, k_pos, scale, (b, g, p, s, d, s_kv, bq, bk, nq, nk)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _flash_forward(cfg: FlashCfg, q, k, v):
    """Returns (out, lse) with lse = logsumexp of each score row."""
    qf, kf, vf, q_pos, k_pos, _, dims = _blocks(cfg, q, k, v)
    b, g, p, s, d, s_kv, bq, bk, nq, nk = dims
    if cfg.causal and cfg.causal_mode == "triangle" and cfg.window is None:
        return _triangle_forward(cfg, qf, kf, vf, q_pos, k_pos, dims)
    n_band = _band(cfg, nk)
    outs, lses = [], []
    for qi in range(nq):
        q_blk = qf[:, :, :, qi]
        j0 = _band_start(cfg, qi, nk, n_band)
        m = torch.full((b, g, p, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, g, p, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, g, p, bq, d), dtype=torch.float32, device=q.device)
        for jj in range(n_band):
            j = j0 + jj
            s_ij = _scores(cfg, q_blk, kf[:, :, j])
            s_ij = torch.where(_mask_for(cfg, q_pos[qi], k_pos[j]), s_ij, NEG_INF)
            m_new = torch.maximum(m, s_ij.amax(-1))
            pexp = torch.exp(s_ij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(-1)
            acc = acc * corr[..., None] + _pv(cfg, pexp, vf[:, :, j])
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        outs.append(acc / l_safe[..., None])
        lses.append(m + torch.log(l_safe))
    out = torch.stack(outs, 3).reshape(b, g, p, s, d)
    lse = torch.stack(lses, 3).reshape(b, g, p, s)
    return out, lse


def _triangle_forward(cfg, qf, kf, vf, q_pos, k_pos, dims):
    """Causal attention over only the lower-triangle block pairs, in the
    JAX package's pair order ((0,0), (1,0), (1,1), …)."""
    b, g, p, s, d, s_kv, bq, bk, nq, nk = dims
    assert nq == nk, "triangle mode requires equal q/kv block counts"
    outs, lses = [], []
    for i in range(nq):
        m = torch.full((b, g, p, bq), NEG_INF, dtype=torch.float32, device=qf.device)
        l = torch.zeros((b, g, p, bq), dtype=torch.float32, device=qf.device)
        acc = torch.zeros((b, g, p, bq, d), dtype=torch.float32, device=qf.device)
        for j in range(i + 1):
            s_ij = _scores(cfg, qf[:, :, :, i], kf[:, :, j])
            s_ij = torch.where(q_pos[i][:, None] >= k_pos[j][None, :], s_ij, NEG_INF)
            m_new = torch.maximum(m, s_ij.amax(-1))
            pexp = torch.exp(s_ij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(-1)
            acc = acc * corr[..., None] + _pv(cfg, pexp, vf[:, :, j])
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        outs.append(acc / l_safe[..., None])
        lses.append(m + torch.log(l_safe))
    out = torch.stack(outs, 3).reshape(b, g, p, s, d)
    lse = torch.stack(lses, 3).reshape(b, g, p, s)
    return out, lse


# ---------------------------------------------------------------------------
# Backward (FlashAttention-2): recompute scores blockwise from (q,k,v,lse)
# ---------------------------------------------------------------------------


def _flash_backward(cfg: FlashCfg, q, k, v, out, lse, dout):
    qf, kf, vf, q_pos, k_pos, scale, dims = _blocks(cfg, q, k, v)
    b, g, p, s, d, s_kv, bq, bk, nq, nk = dims
    dof = dout.to(torch.float32).reshape(b, g, p, nq, bq, d)
    lsef = lse.reshape(b, g, p, nq, bq)
    # D_i = rowsum(dO ⊙ O)
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1).reshape(b, g, p, nq, bq)
    n_band = _band(cfg, nk)
    dk_acc = torch.zeros((b, g, nk, bk, d), dtype=torch.float32, device=q.device)
    dv_acc = torch.zeros_like(dk_acc)
    dq_blocks = []
    for qi in range(nq):
        q_blk, do_blk = qf[:, :, :, qi], dof[:, :, :, qi]
        lse_blk, dlt_blk = lsef[:, :, :, qi], delta[:, :, :, qi]
        j0 = _band_start(cfg, qi, nk, n_band)
        dq_blk = torch.zeros((b, g, p, bq, d), dtype=torch.float32, device=q.device)
        for jj in range(n_band):
            j = j0 + jj
            k_blk, v_blk = kf[:, :, j], vf[:, :, j]
            s_ij = _scores(cfg, q_blk, k_blk)
            s_ij = torch.where(_mask_for(cfg, q_pos[qi], k_pos[j]), s_ij, NEG_INF)
            p_ij = torch.exp(s_ij - lse_blk[..., None])               # (B,G,P,bq,bk)
            # dV_j += Pᵀ dO (contract bq, sum over P)
            dv_j = torch.einsum("bgpqk,bgpqd->bgpkd", _in(cfg, p_ij), _in(cfg, do_blk)).sum(2)
            # dP = dO Vᵀ (contract d)
            dp_ij = torch.einsum("bgpqd,bgkd->bgpqk", _in(cfg, do_blk), _in(cfg, v_blk))
            ds_ij = p_ij * (dp_ij - dlt_blk[..., None])
            # dQ_i += dS K_j (contract bk)
            dq_blk = dq_blk + torch.einsum("bgpqk,bgkd->bgpqd", _in(cfg, ds_ij),
                                           _in(cfg, k_blk))
            # dK_j += dSᵀ Q_i (contract bq, sum over P)
            dk_j = torch.einsum("bgpqk,bgpqd->bgpkd", _in(cfg, ds_ij), _in(cfg, q_blk)).sum(2)
            dk_acc[:, :, j] += dk_j
            dv_acc[:, :, j] += dv_j
        dq_blocks.append(dq_blk * scale)
    dq = torch.stack(dq_blocks, 3).reshape(b, g, p, s, d).to(q.dtype)
    dk = dk_acc.reshape(b, g, s_kv, d).to(k.dtype)
    dv = dv_acc.reshape(b, g, s_kv, d).to(v.dtype)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """``_flash``'s custom VJP: saves (q, k, v, out, lse), recomputes."""

    @staticmethod
    def forward(cfg, q, k, v):
        return _flash_forward(cfg, q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        cfg, q, k, v = inputs
        out, lse = output
        ctx.cfg = cfg
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (None, *_flash_backward(ctx.cfg, q, k, v, out, lse, dout))


def _divisor_block(n: int, target: int) -> int:
    c = min(target, n)
    while n % c != 0:
        c -= 1
    return c


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_block: int = 512,
    kv_block: int = 512,
    causal_mode: str = "masked",
    compute_dtype: str = "bf16",
) -> torch.Tensor:
    """GQA chunked attention with the flash backward.

    q: (B, G, P, S, D) — G kv groups, P q-heads per group
    k, v: (B, G, S_kv, D);  returns (B, G, P, S, D) in q's dtype.
    """
    cfg = FlashCfg(
        causal=causal, window=window,
        q_block=_divisor_block(q.shape[3], q_block),
        kv_block=_divisor_block(k.shape[2], kv_block),
        causal_mode=causal_mode, compute_dtype=compute_dtype,
    )
    out, _ = _Flash.apply(cfg, q, k, v)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """A matmul operand rounded to bf16 and held in float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     t: torch.Tensor, *, window: int | None = None) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q: (B, G, P, D);  k_cache/v_cache: (B, S_cache, G, D);  t: the current
    step, a 0-d int32 tensor (read on the device, never on the host).
    bf16 matmul inputs, float32 accumulation and softmax.
    """
    d = q.shape[-1]
    s_cache = k_cache.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    qf = q.to(torch.float32) * scale
    s = torch.einsum("bgpd,bsgd->bgps", _bf16(qf), _bf16(k_cache))
    slot = torch.arange(s_cache, device=q.device)
    if window is None:
        valid = slot <= t
    else:
        # ring buffer: slot holds position t - ((t - slot) mod S_cache), a
        # floor mod (torch.remainder, as JAX's %)
        pos = t - torch.remainder(t - slot, s_cache)
        valid = (pos >= 0) & (pos > t - window)
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgps,bsgd->bgpd", _bf16(w), _bf16(v_cache))
    return out.to(q.dtype)
