"""Shared helpers of the LM serving parity tests
(``tests/test_torch_lm_serve.py``, ``tests/test_torch_lm_serve_cli.py``).

Tolerances come from a float64 run of the port, as in ``tests/_torch_lm.py``:
``float64_math`` runs the same prefill or decode steps with params, inputs,
caches and every float32 / bf16 op in float64, and ε is the largest
distance, over the logits and the float cache leaves, between the port's
result and that run's.  A fault of the port moves both alike, so it shows as
a distance from JAX's result far beyond ε.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import numpy as np
import torch

from _torch_lm import dev, float64_math
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as T
from repro_torch.parallel.tree import leaves, tree_map

#: a prefill's or a decode step's logits, and every cache leaf, may lie this
#: many rounding levels ε from JAX's: each package lies within about ε of
#: the float64 result, so the two within 2 ε; a bf16 leaf that the two
#: round to neighbouring bf16 numbers lies one unit apart, 2 ε where the
#: float64 run places ε at half a unit (the ten archs and the int8 path
#: measure at most 1.49 ε on the CPU)
SERVE_LEVELS = 2.0


def serve_batch(cfg, b: int = 2, s: int = 12, seed: int = 0) -> dict:
    """A seeded numpy prefill batch for ``cfg``: tokens, and the stub
    embeddings / encoder embeddings the arch reads."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.embeds_input:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def wide(tree):
    """Float leaves of a tree in float64, the others as they are."""
    return tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)


def port_prefill(params, cfg, batch: dict, max_seq: int, *, f64: bool = False):
    """The port's prefill on the CPU from a zero cache: (logits, cache); with
    ``f64`` the same under ``float64_math`` (params, inputs and cfg.dtype in
    float64)."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    b = batch["tokens"].shape[0]
    if not f64:
        with torch.no_grad():
            return tlm.prefill(params, cfg, tb, T.init_cache(cfg, b, max_seq, device="cpu"))
    c64 = dataclasses.replace(cfg, dtype=torch.float64)
    with torch.no_grad(), float64_math():
        return tlm.prefill(wide(params), c64, wide(tb), T.init_cache(c64, b, max_seq,
                                                                      device="cpu"))


def port_decode(params, cfg, cache, tokens: list, enc_embeds=None, *, f64: bool = False):
    """``len(tokens)`` decode steps of the port from ``cache`` (a port
    cache, written in place), teacher-forced with ``tokens`` (each (B,)
    int32 numpy): (logits of each step, the final cache); with ``f64`` the
    same under ``float64_math`` from the cache in float64."""
    if f64:
        params, cache, cfg = wide(params), wide(cache), dataclasses.replace(
            cfg, dtype=torch.float64)
    ctx = float64_math() if f64 else contextlib.nullcontext()
    out = []
    with torch.no_grad(), ctx:
        enc_out = None
        if enc_embeds is not None:
            e = torch.from_numpy(enc_embeds)
            enc_out = tlm.run_encoder(params, cfg, e.double() if f64 else e)
        for tok in tokens:
            logits, cache = tlm.decode_step(params, cfg, torch.from_numpy(np.array(tok)), cache,
                                            enc_out=enc_out)
            out.append(logits)
    return out, cache


def float_leaves(cache) -> list:
    return [c for c in leaves(cache) if c.is_floating_point()]


def rounding_level(logits: list, cache, logits64: list, cache64) -> float:
    """ε: the largest distance, over the logits and the float cache leaves,
    between the port's run and its float64 run."""
    pairs = list(zip(logits, logits64)) + list(zip(float_leaves(cache), float_leaves(cache64)))
    return max(dev(a, b) for a, b in pairs)


def check_cache(got, want_leaves: list, levels_eps: float, what: str) -> float:
    """Every leaf of the port's cache ``got`` against JAX's (numpy, in
    ``jax.tree.leaves`` order): the same shape and dtype, ints equal, floats
    within ``levels_eps``.  Returns the largest float distance."""
    g = leaves(got)
    assert len(g) == len(want_leaves), what
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, want_leaves)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, (what, i, tuple(a.shape), b.shape)
        assert str(a.dtype).replace("torch.", "") == b.dtype.name, (what, i, a.dtype, b.dtype)
        if a.is_floating_point():
            d = dev(a.float(), b.astype(np.float32))
            worst = max(worst, d)
            assert d <= levels_eps, f"{what} cache leaf {i}: {d:.3e} > {levels_eps:.3e}"
        else:
            assert np.array_equal(a.numpy(), b), (what, i)
    return worst


def margin(logits_row) -> float:
    """The top-2 margin of one row of logits."""
    top = np.sort(np.asarray(logits_row, np.float64))[-2:]
    return float(top[1] - top[0])


def same_tokens(got: list, want: list, want_logits: list, eps, what: str) -> int:
    """Request by request, the port's generated tokens ``got`` equal JAX's
    ``want`` (lists of token lists).  Where one differs, JAX's top-2 margin
    at the first differing step (``want_logits[step][request]``) must lie
    within the logit tolerance, 2 · SERVE_LEVELS · ε of the step's largest
    |logit| (each of the two logits may move SERVE_LEVELS · ε): a near tie
    that rounding may break either way.  The test reports it (a warning)
    and compares that request no further; past the tolerance it fails.
    ``eps`` is called for ε where a token differs.  Returns the number of
    near ties reported."""
    ties = 0
    for r, (g, w) in enumerate(zip(got, want)):
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            assert len(g) == len(w), (what, r, g, w)
            continue
        tol = 2 * SERVE_LEVELS * eps() * float(np.abs(want_logits[j]).max())
        m = margin(want_logits[j][r])
        assert m <= tol, (f"{what} request {r}: token {j} is {g[j]}, JAX's {w[j]}, where JAX's "
                          f"top-2 margin {m:.3e} is past the tolerance {tol:.3e}")
        warnings.warn(f"{what} request {r}: token {j} differs ({g[j]} vs JAX's {w[j]}) at a "
                      f"near tie: JAX's top-2 margin {m:.3e} within {tol:.3e}")
        ties += 1
    return ties
