"""The LM train and serve steps (port of ``repro.train.trainer``).

``build_train_step(cfg)`` returns a plain callable ``(state, batch) →
(state, metrics)``: torch runs eagerly, so there is nothing to compile.
The placements JAX's ``build_*`` functions pass to ``jax.jit`` come from
``param_shardings`` / ``batch_spec`` (``NamedSharding``s on a logical
mesh); ``build_prefill`` / ``build_decode_step`` return eager callables
that carry theirs as ``in_shardings`` / ``out_shardings``.  Eager torch
places nothing: the dry run
(``launch/dryrun.py``) reads the placements to size one chip's share, and
``abstract_state`` is the state on the ``meta`` device.  The state is the
JAX package's ``(params, AdamWState, step)`` tuple, leaf for leaf, so
checkpoints in the JAX format restore either way and ``state_from_numpy``
carries a JAX state across.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import cost_hook
from repro_torch.device import DEFAULT_DEVICE, dry_run, resolve_device
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shr
from repro_torch.parallel.tree import leaves, tree_map, unflatten
from repro_torch.train import optimizer as opt


def resolved_rules(cfg: ModelConfig, base_rules: dict) -> dict:
    """The logical-axis rules with the config's overrides (a table only:
    nothing is placed by it on one device)."""
    rules = dict(base_rules)
    for key, value in cfg.rule_overrides:
        if key in ("serve_batch_data_only",):
            continue  # launcher marker, not a logical axis
        rules[key] = value
    return rules


def param_shardings(cfg: ModelConfig, mesh, rules: dict):
    return shr.tree_shardings(mesh, rules, T.logical_axes(cfg))


def batch_spec(cfg: ModelConfig, mesh, rules: dict, *, shapes: dict):
    """NamedShardings for the input batch dict (M-RoPE ``positions`` are
    (3, B, S): the batch is their second dim)."""
    b_axes = rules.get("batch")

    def spec_for(name, ndim):
        if name == "positions" and cfg.mrope_sections is not None:
            return shr.NamedSharding(mesh, shr.P(None, b_axes, None))
        return shr.NamedSharding(mesh, shr.P(b_axes, *[None] * (ndim - 1)))

    return {k: spec_for(k, len(v)) for k, v in shapes.items()}


def loss_fn(params, cfg: ModelConfig, batch, causal_mode="masked"):
    if cfg.cast_params_once:
        # one explicit cast at the step boundary; the backward of the cast
        # brings the gradients back to float32
        params = tree_map(
            lambda p: p.to(cfg.dtype) if p.dtype == torch.float32 else p, params)
    return lm.train_loss(params, cfg, batch, causal_mode=causal_mode)


def value_and_grad(params, cfg: ModelConfig, batch, causal_mode="masked"):
    """``((loss, metrics), grads)`` as ``jax.value_and_grad(loss_fn,
    has_aux=True)`` gives them: a leaf the loss does not reach gets a zero
    gradient (as JAX's), not ``None``."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(params, cfg, batch, causal_mode)
    flat = leaves(params)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p) for p, g in zip(flat, grads)]
    cost_hook.gradients(grads)  # the dry run sizes them as their params
    grads = unflatten(params, grads)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def train_step(state, cfg: ModelConfig, batch, *, causal_mode="masked",
               total_steps: int = 10_000):
    """Pure step: (params, opt, step) + batch → new state + metrics."""
    params, opt_state, step = state
    (_, metrics), grads = value_and_grad(params, cfg, batch, causal_mode)
    lr = opt.lr_schedule(step, peak=cfg.learning_rate, total=total_steps)
    new_params, new_opt, gnorm = opt.update(params, grads, opt_state, lr=lr,
                                            weight_decay=cfg.weight_decay)
    metrics = dict(metrics)
    metrics["grad_norm"] = gnorm
    metrics["lr"] = lr
    return (new_params, new_opt, step + 1), metrics


def build_train_step(cfg: ModelConfig, *, causal_mode: str = "masked",
                     total_steps: int = 10_000):
    """The train step as a callable ``(state, batch) → (state, metrics)``
    on the device the state lies on."""

    def fn(state, batch):
        return train_step(state, cfg, batch, causal_mode=causal_mode,
                          total_steps=total_steps)

    return fn


def init_state(key, cfg: ModelConfig, device=DEFAULT_DEVICE):
    """``(params, AdamWState, step)`` from ``key``, as the JAX package's."""
    device = resolve_device(device)
    params = T.init_params(key, cfg, device=device)
    return (params, opt.init(params),
            torch.zeros((), dtype=torch.int32, device=device))


def abstract_state(key, cfg: ModelConfig):
    """The train state on the ``meta`` device: every leaf's shape and
    dtype, nothing allocated (a 72B-parameter config on a host without a
    card).  The draws run on meta from the real key, which stays on the
    CPU (``prng`` reads its words on the host)."""
    with dry_run():
        return init_state(key, cfg, device="meta")


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def build_decode_step(cfg: ModelConfig, mesh, rules: dict, *, has_enc: bool = False):
    """The single-token decode step ``(params, tokens, cache[, enc_out]) →
    (logits, cache)`` with its placements as ``in_shardings`` /
    ``out_shardings`` (JAX's jit arguments); the KV caches are written in
    place."""
    p_shard = param_shardings(cfg, mesh, rules)
    c_shard = shr.tree_shardings(mesh, rules, T.cache_logical_axes(cfg))
    b_axes = rules.get("batch")
    tok_shard = shr.NamedSharding(mesh, shr.P(b_axes))
    in_sh = (p_shard, tok_shard, c_shard)
    if has_enc:
        in_sh += (shr.NamedSharding(mesh, shr.P(b_axes, None, None)),)

    def fn(params, tokens, cache, enc_out=None):
        return lm.decode_step(params, cfg, tokens, cache, enc_out=enc_out)

    fn.in_shardings = in_sh
    fn.out_shardings = (shr.NamedSharding(mesh, shr.P(b_axes, rules.get("vocab"))),
                        c_shard)
    return fn


def build_prefill(cfg: ModelConfig, mesh, rules: dict, *, shapes: dict):
    """The prefill ``(params, batch, cache) → (logits, cache)`` with its
    placements as ``in_shardings`` / ``out_shardings``."""
    p_shard = param_shardings(cfg, mesh, rules)
    c_shard = shr.tree_shardings(mesh, rules, T.cache_logical_axes(cfg))

    def fn(params, batch, cache):
        return lm.prefill(params, cfg, batch, cache)

    fn.in_shardings = (p_shard, batch_spec(cfg, mesh, rules, shapes=shapes), c_shard)
    fn.out_shardings = (
        shr.NamedSharding(mesh, shr.P(rules.get("batch"), rules.get("vocab"))), c_shard)
    return fn


# ---------------------------------------------------------------------------
# Weights carried across
# ---------------------------------------------------------------------------


def tree_from_numpy(tree, device=DEFAULT_DEVICE) -> Any:
    """A numpy tree (dicts, lists, arrays; bfloat16 arrays as ml_dtypes
    gives them) as torch tensors on ``device``, structure kept."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [tree_from_numpy(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def state_from_numpy(state, device=DEFAULT_DEVICE):
    """A JAX LM train state ``(params, AdamWState(mu, nu, count), step)``
    with numpy leaves (stacked unit leaves included, as
    ``jax.tree.map(np.asarray, state)`` gives it) as the port's state."""
    params, adam, step = state
    return (tree_from_numpy(params, device),
            opt.AdamWState(mu=tree_from_numpy(adam.mu, device),
                           nu=tree_from_numpy(adam.nu, device),
                           count=tree_from_numpy(adam.count, device)),
            tree_from_numpy(step, device))
