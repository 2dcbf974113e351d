"""The generic decoder/encoder stack covering every assigned architecture
(port of ``repro.models.transformer``, the training half).

Layer layout is ``cfg.scan_unit × cfg.scan_repeats + cfg.tail``: the
parameters of each kind are stacked on a leading dim, as the JAX package
stacks them for ``lax.scan`` (so checkpoints and weights carry across leaf
for leaf); ``lm.run_stack`` runs the units one after another.

GQA: KV heads are expanded (repeated) to the full query-head count before
attention, as the JAX package does for its head-sharded attention.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import prng
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import flash_attention
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                         head_rms_norm, rms_norm)
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------


def init_attn_layer(key, cfg: ModelConfig, *, cross: bool = False, device="cpu") -> dict:
    d, h, g, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = prng.split(key, 8)
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)  # noqa: E731
    p = {
        "ln1": zeros(d),
        "ln2": zeros(d),
        "wq": dense_init(ks[0], (d, h, hd), d, device=device),
        "wk": dense_init(ks[1], (d, g, hd), d, device=device),
        "wv": dense_init(ks[2], (d, g, hd), d, device=device),
        "wo": dense_init(ks[3], (h, hd, d), h * hd, device=device),
        "mlp": mlp_mod.init_mlp(ks[4], cfg, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(hd)
        p["k_norm"] = zeros(hd)
    if cross:
        p["ln_x"] = zeros(d)
        p["xq"] = dense_init(ks[5], (d, h, hd), d, device=device)
        p["xk"] = dense_init(ks[6], (d, g, hd), d, device=device)
        p["xv"] = dense_init(ks[7], (d, g, hd), d, device=device)
        p["xo"] = dense_init(ks[5], (h, hd, d), h * hd, device=device)
    return p


def attn_logical_axes(cfg: ModelConfig, *, cross: bool = False) -> dict:
    p = {
        "ln1": (None,), "ln2": (None,),
        "wq": ("p_fsdp", "p_heads", None),
        "wk": ("p_fsdp", "p_kv_heads", None),
        "wv": ("p_fsdp", "p_kv_heads", None),
        "wo": ("p_heads", None, "p_fsdp"),
        "mlp": mlp_mod.mlp_logical_axes(cfg),
    }
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    if cross:
        p.update({
            "ln_x": (None,),
            "xq": ("p_fsdp", "p_heads", None),
            "xk": ("p_fsdp", "p_kv_heads", None),
            "xv": ("p_fsdp", "p_kv_heads", None),
            "xo": ("p_heads", None, "p_fsdp"),
        })
    return p


def init_layer(key, cfg: ModelConfig, kind: str, device="cpu") -> dict:
    if kind in ("attn", "local_attn", "enc_attn"):
        return init_attn_layer(key, cfg, device=device)
    if kind == "attn_cross":
        return init_attn_layer(key, cfg, cross=True, device=device)
    if kind == "rec":
        return init_rglru_layer_with_mlp(key, cfg, device=device)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_layer(key, cfg, device=device)
    raise ValueError(f"unknown layer kind {kind!r}")


def init_rglru_layer_with_mlp(key, cfg: ModelConfig, device="cpu") -> dict:
    k1, k2 = prng.split(key)
    p = rglru_mod.init_rglru_layer(k1, cfg, device=device)
    p["ln2"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    p["mlp"] = mlp_mod.init_mlp(k2, cfg, device=device)
    return p


def layer_logical_axes(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("attn", "local_attn", "enc_attn"):
        return attn_logical_axes(cfg)
    if kind == "attn_cross":
        return attn_logical_axes(cfg, cross=True)
    if kind == "rec":
        p = rglru_mod.rglru_logical_axes(cfg)
        p["ln2"] = (None,)
        p["mlp"] = mlp_mod.mlp_logical_axes(cfg)
        return p
    if kind == "rwkv":
        return rwkv_mod.rwkv_logical_axes(cfg)
    raise ValueError(kind)


def _stack(trees: list):
    """Stack matching trees leaf by leaf on a new leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_params(key, cfg: ModelConfig, device=DEFAULT_DEVICE) -> dict:
    """Full model parameters: embeddings + stacked units + tail (+ encoder),
    drawn from ``key`` as the JAX package draws them (``prng.normal``)."""
    device = resolve_device(device)
    keys = prng.split(key, 6)
    d, v = cfg.d_model, cfg.vocab_size
    # gemma-style: σ_embed = 1/√d, inputs rescaled by √d at lookup
    params: dict[str, Any] = {
        "embed": dense_init(keys[0], (v, d), d, device=device),
        "final_ln": torch.zeros((d,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(keys[1], (d, v), d, device=device)

    scan_params = []
    for uk in prng.split(keys[2], cfg.scan_repeats):
        layer_keys = prng.split(uk, len(cfg.scan_unit))
        scan_params.append({f"u{i}": init_layer(k, cfg, kind, device=device)
                            for i, (kind, k) in enumerate(zip(cfg.scan_unit, layer_keys))})
    params["scan"] = _stack(scan_params)

    tail_keys = prng.split(keys[3], max(len(cfg.tail), 1))
    params["tail"] = [init_layer(k, cfg, kind, device=device)
                      for kind, k in zip(cfg.tail, tail_keys)]

    if cfg.encoder_layers:
        enc_keys = prng.split(keys[4], cfg.encoder_layers)
        params["encoder"] = _stack(
            [{"u0": init_layer(k, cfg, "enc_attn", device=device)} for k in enc_keys])
        params["enc_final_ln"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return params


def logical_axes(cfg: ModelConfig) -> dict:
    """Same structure as init_params, leaves = logical axis tuples."""
    axes: dict[str, Any] = {"embed": ("p_vocab", "p_embed"), "final_ln": (None,)}
    if not cfg.tie_embeddings:
        axes["unembed"] = ("p_embed", "p_vocab")

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return ("stack", *tree)

    axes["scan"] = stacked({f"u{i}": layer_logical_axes(cfg, kind)
                            for i, kind in enumerate(cfg.scan_unit)})
    axes["tail"] = [layer_logical_axes(cfg, kind) for kind in cfg.tail]
    if cfg.encoder_layers:
        axes["encoder"] = stacked({"u0": layer_logical_axes(cfg, "enc_attn")})
        axes["enc_final_ln"] = (None,)
    return axes


# ---------------------------------------------------------------------------
# Layer forward
# ---------------------------------------------------------------------------


def _project_qkv(p, cfg: ModelConfig, xn, positions):
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"].to(xn.dtype))
    k = torch.einsum("bsd,dgk->bsgk", xn, p["wk"].to(xn.dtype))
    v = torch.einsum("bsd,dgk->bsgk", xn, p["wv"].to(xn.dtype))
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"])
        k = head_rms_norm(k, p["k_norm"])
    if positions is not None:
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, repeats: int) -> torch.Tensor:
    """(B,S,G,D) → (B,S,G·r,D): each KV head repeated r times."""
    if repeats == 1:
        return k
    return torch.repeat_interleave(k, repeats, dim=2)


def _attend(q, k, v, **kw):
    """(B,S,H,D) q and expanded k, v → (B,S,H,D) through flash_attention's
    (B, groups, per-group, S, D) signature."""
    out = flash_attention(q.movedim(1, 2)[:, :, None], k.movedim(1, 2), v.movedim(1, 2), **kw)
    return out[:, :, 0].movedim(1, 2)


def attn_layer(p: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
               window: int | None, causal: bool = True, causal_mode: str = "masked"):
    """Full-sequence attention + MLP block (training / encoder).
    Returns (x, aux)."""
    xn = rms_norm(x, p["ln1"])
    q, k, v = _project_qkv(p, cfg, xn, positions)
    k = _expand_kv(k, cfg.q_per_kv)
    v = _expand_kv(v, cfg.q_per_kv)
    out = _attend(q, k, v, causal=causal, window=window, causal_mode=causal_mode)
    x = x + torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))

    xn2 = rms_norm(x, p["ln2"])
    if cfg.moe is not None:
        mlp_out, aux = mlp_mod.moe_mlp(p["mlp"], cfg, xn2)
    else:
        mlp_out = mlp_mod.dense_mlp(p["mlp"], cfg, xn2)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_out, aux


def cross_attn(p: dict, cfg: ModelConfig, x: torch.Tensor, enc_out: torch.Tensor):
    """Encoder-decoder cross attention (whisper).  Non-causal, no cache."""
    xn = rms_norm(x, p["ln_x"])
    q = torch.einsum("bsd,dhk->bshk", xn, p["xq"].to(xn.dtype))
    k = torch.einsum("bsd,dgk->bsgk", enc_out, p["xk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dgk->bsgk", enc_out, p["xv"].to(enc_out.dtype))
    k = _expand_kv(k, cfg.q_per_kv)
    v = _expand_kv(v, cfg.q_per_kv)
    out = _attend(q, k, v, causal=False, window=None)
    return x + torch.einsum("bshk,hkd->bsd", out, p["xo"].to(out.dtype))


def rec_layer(p, cfg, x, state):
    """RG-LRU block + MLP (recurrentgemma 'rec' layer)."""
    h, new_state = rglru_mod.rglru_block(p, cfg, x, state)
    x = x + h
    return x + mlp_mod.dense_mlp(p["mlp"], cfg, rms_norm(x, p["ln2"])), new_state
