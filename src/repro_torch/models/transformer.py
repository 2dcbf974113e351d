"""The generic decoder/encoder stack covering every assigned architecture,
and its KV / recurrent caches (port of ``repro.models.transformer``).

Layer layout is ``cfg.scan_unit × cfg.scan_repeats + cfg.tail``: the
parameters of each kind are stacked on a leading dim, as the JAX package
stacks them for ``lax.scan`` (so checkpoints and weights carry across leaf
for leaf); ``lm.run_stack`` runs the units one after another.

GQA: KV heads are expanded (repeated) to the full query-head count before
attention, as the JAX package does for its head-sharded attention.  The
decode cache stores them ``cfg.kv_repeat``× (JAX's Megatron duplication)
and groups the query heads onto the stored heads.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                         head_rms_norm, rms_norm)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.tree import tree_map

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
# KV / recurrent caches
# ---------------------------------------------------------------------------


class LayerCache(NamedTuple):
    """Cache for one attention layer (decode).  KV heads stored pre-repeated
    ``cfg.kv_repeat``×."""

    k: torch.Tensor  # (B, S_cache, G·R, hd)
    v: torch.Tensor


def _cache_len(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    if kind == "local_attn":
        return min(max_seq, cfg.local_attn_window)
    if cfg.sliding_window is not None:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, device="cpu"):
    if kind in ("attn", "local_attn", "attn_cross"):
        g = cfg.num_kv_heads * cfg.kv_repeat
        shape = (batch, _cache_len(cfg, kind, max_seq), g, cfg.head_dim)
        return LayerCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                          v=torch.zeros(shape, dtype=cfg.dtype, device=device))
    if kind == "rec":
        return rglru_mod.init_rglru_state(cfg, batch, device)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_state(cfg, batch, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=DEFAULT_DEVICE) -> dict:
    """Zero caches: each unit kind's stacked on a leading dim of
    ``cfg.scan_repeats`` (JAX's scan layout), the tail's one by one, and the
    step ``t`` (0-d int32)."""
    device = resolve_device(device)
    unit = {f"u{i}": init_layer_cache(cfg, kind, batch, max_seq, device)
            for i, kind in enumerate(cfg.scan_unit)}
    return {
        "scan": tree_map(lambda x: x.expand(cfg.scan_repeats, *x.shape).clone(), unit),
        "tail": [init_layer_cache(cfg, kind, batch, max_seq, device) for kind in cfg.tail],
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical axis names of the cache tree (JAX's sharding rules)."""
    def layer_axes(kind, stacked: bool):
        pre = ("stack",) if stacked else ()
        if kind in ("attn", "local_attn", "attn_cross"):
            kv = ("batch", "kv_seq", "kv_cache_heads", None)
            return LayerCache(k=pre + kv, v=pre + kv)
        if kind == "rec":
            return rglru_mod.RglruState(h=pre + ("batch", "rnn"),
                                        conv=pre + ("batch", None, "rnn"))
        if kind == "rwkv":
            return rwkv_mod.RwkvState(s=pre + ("batch", "rnn", None, None),
                                      x_prev_tm=pre + ("batch", None),
                                      x_prev_cm=pre + ("batch", None))
        raise ValueError(kind)

    return {
        "scan": {f"u{i}": layer_axes(kind, True) for i, kind in enumerate(cfg.scan_unit)},
        "tail": [layer_axes(kind, False) for kind in cfg.tail],
        "t": (),
    }


#: the cache's NamedTuples by their fields (JAX's have the same names)
_CACHE_TYPES = {cls._fields: cls for cls in (LayerCache, rglru_mod.RglruState,
                                             rwkv_mod.RwkvState)}


def cache_from_numpy(tree, device=DEFAULT_DEVICE):
    """A JAX cache tree with numpy leaves (``jax.tree.map(np.asarray,
    cache)``: dicts, lists and the three cache NamedTuples; bfloat16 as
    ml_dtypes gives it) as the port's cache on ``device``, dtypes kept."""
    from repro_torch.train.trainer import tree_from_numpy  # the trainer imports this module

    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: cache_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return _CACHE_TYPES[tuple(tree._fields)](
            *(tree_from_numpy(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [cache_from_numpy(v, device) for v in tree]
    return tree_from_numpy(tree, device)


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


def attn_layer_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, t: torch.Tensor,
                      cache: LayerCache, *, window: int | None,
                      enc_out: torch.Tensor | None = None) -> tuple[torch.Tensor, LayerCache]:
    """Single-token attention + MLP with cache update.  x: (B, d).

    This step's K/V (duplicated R×) go into ring slot ``t % S_cache`` of
    ``cache``'s tensors in place (JAX's update with the buffer donated),
    the slot indexed on the device; the same tensors come back."""
    b, _ = x.shape
    xn = rms_norm(x[:, None, :], p["ln1"])
    t32 = t.to(torch.int32)
    pos = t32[None, None] if cfg.mrope_sections is None else t32.expand(3, b, 1)
    q, k, v = _project_qkv(p, cfg, xn, pos)
    slot = torch.remainder(t, cache.k.shape[1]).to(torch.int64).reshape(1)
    cache.k.index_copy_(1, slot, _expand_kv(k, cfg.kv_repeat).to(cache.k.dtype))
    cache.v.index_copy_(1, slot, _expand_kv(v, cfg.kv_repeat).to(cache.v.dtype))
    # group query heads onto the duplicated-KV slots
    g_pad = cfg.num_kv_heads * cfg.kv_repeat
    qd = q[:, 0].reshape(b, g_pad, cfg.num_heads // g_pad, cfg.head_dim)
    out = decode_attention(qd, cache.k, cache.v, t, window=window)
    out = out.reshape(b, cfg.num_heads, cfg.head_dim)
    x = x + torch.einsum("bhk,hkd->bd", out, p["wo"].to(out.dtype))
    if enc_out is not None:
        x = cross_attn(p, cfg, x[:, None, :], enc_out)[:, 0]
    xn2 = rms_norm(x[:, None, :], p["ln2"])
    if cfg.moe is not None:
        mlp_out, _ = mlp_mod.moe_mlp(p["mlp"], cfg, xn2)
    else:
        mlp_out = mlp_mod.dense_mlp(p["mlp"], cfg, xn2)
    return x + mlp_out[:, 0], cache


def rec_layer(p, cfg, x, state, *, decode=False):
    """RG-LRU block + MLP (recurrentgemma 'rec' layer); ``decode``: x is
    one token (B, d)."""
    h, new_state = rglru_mod.rglru_block(p, cfg, x, state, decode=decode)
    x = x + h
    out = mlp_mod.dense_mlp(p["mlp"], cfg, rms_norm(x[:, None, :] if decode else x, p["ln2"]))
    return x + (out[:, 0] if decode else out), new_state
