"""Model facade (port of ``repro.models.lm``), three entry points:

  * ``train_loss``  — a full-sequence forward + next-token cross-entropy
    (+ the MoE aux loss, + the LES local-group losses when
    ``cfg.les_groups > 0``);
  * ``prefill``     — the full-sequence forward that also fills the KV /
    recurrent caches and returns the last position's logits;
  * ``decode_step`` — one token against the caches.

LES mode (the paper's learning algorithm, applied to LMs): the stacked
units are split into ``les_groups`` segments with a stop-gradient
(``detach``) between them; each segment gets a local next-token loss
through the shared unembedding, so gradients stay inside their segment,
as in NITRO-D's integer local-loss blocks.

Remat: with ``cfg.remat`` each unit runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of the scan body), so
only the residual stream between units is kept; the cross-entropy always
recomputes each sequence chunk's logits in the backward.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.tree import tree_map

# ---------------------------------------------------------------------------
# Stack execution
# ---------------------------------------------------------------------------


def _unit_forward(cfg: ModelConfig, unit_params: dict, x, positions, causal_mode):
    """One unit (e.g. ('rec','rec','attn')) over a full sequence; recurrent
    states start at zero.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(cfg.scan_unit):
        p = unit_params[f"u{i}"]
        if kind in ("attn", "local_attn"):
            window = cfg.sliding_window if kind == "attn" else cfg.local_attn_window
            x, a = T.attn_layer(p, cfg, x, positions, window=window, causal_mode=causal_mode)
            aux = aux + a
        elif kind == "rec":
            x, _ = T.rec_layer(p, cfg, x, T.rglru_mod.init_rglru_state(cfg, x.shape[0],
                                                                         x.device))
        elif kind == "rwkv":
            x, _ = T.rwkv_mod.rwkv_layer(p, cfg, x, T.rwkv_mod.init_rwkv_state(
                cfg, x.shape[0], x.device))
        else:
            raise ValueError(kind)
    return x, aux


def _unit(tree, i: int):
    """Unit ``i`` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _unit(v, i) for k, v in tree.items()}
    return tree[i]


def _n_units(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _run_units(cfg, stacked, x, aux, body, lo: int, hi: int):
    """Units [lo, hi) of ``stacked`` through ``body(unit, x) -> (x, a)``,
    each under checkpoint when ``cfg.remat``."""
    for i in range(lo, hi):
        unit = _unit(stacked, i)
        if cfg.remat:
            x, a = checkpoint(body, unit, x, use_reentrant=False)
        else:
            x, a = body(unit, x)
        aux = aux + a
    return x, aux


def run_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
              causal_mode: str = "masked", collect_les: bool = False):
    """Run the stacked units + tail.  Returns (x, aux, les_taps)."""

    def body(unit, h):
        return _unit_forward(cfg, unit, h, positions, causal_mode)

    les_taps = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    reps = _n_units(params["scan"])
    if collect_les and cfg.les_groups > 0:
        per = max(reps // cfg.les_groups, 1)
        offset = 0
        while offset < reps:
            n = min(per, reps - offset)
            x, aux = _run_units(cfg, params["scan"], x, aux, body, offset, offset + n)
            les_taps.append(x)
            x = x.detach()  # confine gradients to the group
            offset += n
    else:
        x, aux = _run_units(cfg, params["scan"], x, aux, body, 0, reps)

    for p, kind in zip(params["tail"], cfg.tail):
        x, aux = _tail_forward(cfg, p, kind, x, positions, causal_mode, aux)
    return x, aux, les_taps


def _tail_forward(cfg, p, kind, x, positions, causal_mode, aux):
    if kind in ("attn", "local_attn"):
        window = cfg.sliding_window if kind == "attn" else cfg.local_attn_window
        x, a = T.attn_layer(p, cfg, x, positions, window=window, causal_mode=causal_mode)
        return x, aux + a
    if kind == "rec":
        x, _ = T.rec_layer(p, cfg, x, T.rglru_mod.init_rglru_state(cfg, x.shape[0], x.device))
        return x, aux
    if kind == "rwkv":
        x, _ = T.rwkv_mod.rwkv_layer(p, cfg, x, T.rwkv_mod.init_rwkv_state(
            cfg, x.shape[0], x.device))
        return x, aux
    raise ValueError(kind)


def _embed(params, cfg: ModelConfig, tokens_or_embeds):
    if cfg.embeds_input:
        return tokens_or_embeds.to(cfg.dtype)
    scale = torch.sqrt(torch.tensor(cfg.d_model, dtype=torch.float32)).to(cfg.dtype)
    return params["embed"].to(cfg.dtype)[tokens_or_embeds] * scale.to(
        tokens_or_embeds.device)


def _logits(params, cfg: ModelConfig, x):
    """bf16 (the compute dtype) inputs, float32 accumulation: the rounded
    operands multiplied in float32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x.to(cfg.dtype).to(torch.float32) @ w.to(cfg.dtype).to(torch.float32)


def _positions(cfg: ModelConfig, b: int, s: int, device):
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)
    if cfg.mrope_sections is not None:
        return pos[None].expand(3, b, s)  # text-stream M-RoPE
    return pos


def run_encoder(params, cfg: ModelConfig, enc_embeds: torch.Tensor):
    """Whisper encoder: non-causal stack over stub frontend embeddings."""

    def body(unit, h):
        return T.attn_layer(unit["u0"], cfg, h, None, window=None, causal=False)

    zero = torch.zeros((), dtype=torch.float32, device=enc_embeds.device)
    h, _ = _run_units(cfg, params["encoder"], enc_embeds.to(cfg.dtype), zero, body,
                      0, _n_units(params["encoder"]))
    return T.rms_norm(h, params["enc_final_ln"])


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _pick_chunk(s: int, target: int = 512) -> int:
    c = min(target, s)
    while s % c != 0:
        c -= 1
    return c


def _chunk_nll(params, cfg, xc, lc):
    """−Σ log p(label) over one sequence chunk."""
    logz = torch.log_softmax(_logits(params, cfg, xc), dim=-1)
    return -torch.gather(logz, -1, lc[..., None].long())[..., 0].sum()


def _chunked_xent(params, cfg: ModelConfig, x: torch.Tensor, labels: torch.Tensor):
    """Next-token CE without materialising (B, S, V) logits: the
    unembedding + softmax run per sequence chunk under checkpoint, so the
    backward recomputes each chunk's logits."""
    b, s, _ = x.shape
    chunk = _pick_chunk(s)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        loss_sum = loss_sum + checkpoint(_chunk_nll, params, cfg, x[:, sl], labels[:, sl],
                                         use_reentrant=False)
    return loss_sum / (b * s)


def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               causal_mode: str = "masked") -> tuple[torch.Tensor, dict]:
    """Next-token CE over the full sequence.

    batch: {"tokens": (B,S) int32 (or "embeds": (B,S,d) for stub-frontend
    archs), "labels": (B,S) int32, optional "positions", "enc_embeds"}.
    """
    inp = batch["embeds"] if cfg.embeds_input else batch["tokens"]
    b, s = batch["labels"].shape
    x = _embed(params, cfg, inp)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(cfg, b, s, x.device)

    if cfg.encoder_layers:
        enc_out = run_encoder(params, cfg, batch["enc_embeds"])
        x, aux, les_taps = _run_decoder_with_cross(params, cfg, x, positions, enc_out,
                                                   causal_mode)
    else:
        x, aux, les_taps = run_stack(params, cfg, x, positions, causal_mode=causal_mode,
                                     collect_les=cfg.les_groups > 0)

    x = T.rms_norm(x, params["final_ln"])
    loss = _chunked_xent(params, cfg, x, batch["labels"])
    metrics = {"ce": loss, "aux": aux}
    if les_taps:
        # LES: every group (incl. the last) trains through its local head;
        # the main CE then reaches only the output head (x was detached at
        # the last tap), NITRO-D's output-layer treatment
        les_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for tap in les_taps:
            les_loss = les_loss + _chunked_xent(
                params, cfg, T.rms_norm(tap, params["final_ln"]), batch["labels"])
        loss = loss + les_loss / len(les_taps)
        metrics["les"] = les_loss
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux / max(cfg.num_layers, 1)
    metrics["loss"] = loss
    return loss, metrics


def _run_decoder_with_cross(params, cfg, x, positions, enc_out, causal_mode):
    """Whisper decoder: self-attn (causal) + cross-attn per layer."""

    def body(unit, h):
        p = unit["u0"]
        h, a = T.attn_layer(p, cfg, h, positions, window=None, causal_mode=causal_mode)
        return T.cross_attn(p, cfg, h, enc_out), a

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = _run_units(cfg, params["scan"], x, zero, body, 0, _n_units(params["scan"]))
    return x, aux, []


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def _window(cfg: ModelConfig, kind: str):
    return cfg.local_attn_window if kind == "local_attn" else cfg.sliding_window


def _unit_cache(tree, i: int):
    """Unit ``i`` of a stacked cache tree (views of its tensors)."""
    return tree_map(lambda t: t[i], tree)


def _prefill_layer(p, cfg, kind, h, positions, c, enc_out):
    """One layer of the prefill: the train-mode forward, and its cache."""
    if kind in ("attn", "local_attn", "attn_cross"):
        # the cache is filled from the layer *input* (the tensor the layer's
        # attention projects), before the layer moves h
        c = _fill_kv_cache(p, cfg, h, positions, c)
        h, _ = T.attn_layer(p, cfg, h, positions, window=_window(cfg, kind))
        if kind == "attn_cross":
            h = T.cross_attn(p, cfg, h, enc_out)
        return h, c
    if kind == "rec":
        return T.rec_layer(p, cfg, h, T.rglru_mod.init_rglru_state(cfg, h.shape[0], h.device))
    if kind == "rwkv":
        return T.rwkv_mod.rwkv_layer(p, cfg, h, T.rwkv_mod.init_rwkv_state(
            cfg, h.shape[0], h.device))
    raise ValueError(kind)


def _decode_layer(p, cfg, kind, h, t, c, enc_out):
    """One layer of a decode step against its cache."""
    if kind in ("attn", "local_attn", "attn_cross"):
        return T.attn_layer_decode(p, cfg, h, t, c, window=_window(cfg, kind),
                                   enc_out=enc_out if kind == "attn_cross" else None)
    if kind == "rec":
        return T.rec_layer(p, cfg, h, c, decode=True)
    if kind == "rwkv":
        return T.rwkv_mod.rwkv_layer(p, cfg, h, c, decode=True)
    raise ValueError(kind)


def _run_cached(params, cfg, cache, x, layer):
    """The stacked units one after another, then the tail, each layer by
    ``layer(p, kind, x, its cache) -> (x, its new cache)``.  Returns x and
    the new "scan" / "tail" caches: an attention layer's KV tensors are
    those of ``cache`` (written in place), the recurrent states new
    tensors, stacked per unit kind."""
    per_unit = []
    for i in range(_n_units(params["scan"])):
        unit, unit_cache, new = _unit(params["scan"], i), _unit_cache(cache["scan"], i), {}
        for j, kind in enumerate(cfg.scan_unit):
            x, new[f"u{j}"] = layer(unit[f"u{j}"], kind, x, unit_cache[f"u{j}"])
        per_unit.append(new)
    scan = {}
    for j, kind in enumerate(cfg.scan_unit):
        key = f"u{j}"
        if isinstance(cache["scan"][key], T.LayerCache):
            scan[key] = cache["scan"][key]
        else:
            scan[key] = tree_map(lambda *xs: torch.stack(xs), *[u[key] for u in per_unit])
    tail = []
    for p, kind, c in zip(params["tail"], cfg.tail, cache["tail"]):
        x, c = layer(p, kind, x, c)
        tail.append(c)
    return x, scan, tail


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that fills the caches: the train-mode forward
    (flash attention, the matmul form of the recurrences) per layer, each
    attention layer's K/V laid into its (ring) cache in place, each
    recurrent layer's state from a zero state.  Returns the last
    position's logits and the cache with ``t = s``."""
    inp = batch["embeds"] if cfg.embeds_input else batch["tokens"]
    b, s = inp.shape[0], inp.shape[1]
    x = _embed(params, cfg, inp)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(cfg, b, s, x.device)
    enc_out = run_encoder(params, cfg, batch["enc_embeds"]) if cfg.encoder_layers else None

    x, scan, tail = _run_cached(params, cfg, cache, x, lambda p, kind, h, c: _prefill_layer(
        p, cfg, kind, h, positions, c, enc_out))
    x = T.rms_norm(x, params["final_ln"])
    logits = _logits(params, cfg, x[:, -1, :])
    return logits, {"scan": scan, "tail": tail,
                    "t": torch.tensor(s, dtype=torch.int32, device=x.device)}


def _fill_kv_cache(p, cfg: ModelConfig, x_in, positions, cache: T.LayerCache) -> T.LayerCache:
    """K/V from the layer input laid into the (ring) cache, in place.  For
    windows shorter than the sequence only the last ``S_cache`` entries are
    kept, rotated so slot ``p % S_cache`` holds position ``p``."""
    xn = T.rms_norm(x_in, p["ln1"])
    _, k, v = T._project_qkv(p, cfg, xn, positions)
    k = T._expand_kv(k, cfg.kv_repeat)
    v = T._expand_kv(v, cfg.kv_repeat)
    s_cache, s = cache.k.shape[1], k.shape[1]
    if s >= s_cache:  # keep the last window, ring-ordered
        start = (s - s_cache) % s_cache
        cache.k.copy_(torch.roll(k[:, -s_cache:], start, dims=1))
        cache.v.copy_(torch.roll(v[:, -s_cache:], start, dims=1))
    else:
        cache.k[:, :s].copy_(k)
        cache.v[:, :s].copy_(v)
    return cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                enc_out: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """One greedy decode step.  tokens: (B,) int32 → (logits, new cache);
    the KV caches are written in place (``T.attn_layer_decode``)."""
    t = cache["t"]
    # decode always consumes token ids (stub-frontend archs emit text too)
    scale = torch.sqrt(torch.tensor(cfg.d_model, dtype=torch.float32)).to(cfg.dtype)
    x = params["embed"].to(cfg.dtype)[tokens] * scale.to(tokens.device)

    x, scan, tail = _run_cached(params, cfg, cache, x, lambda p, kind, h, c: _decode_layer(
        p, cfg, kind, h, t, c, enc_out))
    x = T.rms_norm(x[:, None, :], params["final_ln"])[:, 0]
    return _logits(params, cfg, x), {"scan": scan, "tail": tail, "t": t + 1}
