"""The measured tile search: candidates → parity gate → ABBA timing → cache
(port of ``repro.kernels.autotune.search``).

``tune()`` solves one problem, one ``(op, shape, dtype, backend,
conv_mode, fuse_bwd)`` cache key:

1. build integer operands for the op from a seeded ``numpy`` generator,
   in [−63, 64), as the JAX package draws them (the plain stream conv's
   time does not depend on the values);
2. list the candidates and the *effective default*, the tiles the
   dispatcher uses with no cache entry, so the winner can never be slower
   than the fallback in the session;
3. **parity gate**: run every candidate once and require bitwise equality
   with the ``reference`` backend, else ``ParityError`` (integer sums are
   exact in any order, so a mismatch is a fault, not noise);
4. time every candidate in **one** ``measure.time_paired`` session;
5. put the argmin into the cache (if one is given) and return
   ``(winner, {config: best_us})``.

Ops vocabulary (shapes are the cache-key shapes), as in the JAX package:

====================  =========================  =========================
op                    shape                      dispatcher
====================  =========================  =========================
``matmul``            (M, K, N)                  ``fused_matmul``
``matmul_fwd``        (M, K, N)                  ``fused_matmul_fwd``
``matmul_grad_w``     (B, M, N)                  ``grad_w_matmul``
``matmul_grad_x``     (B, N, M)                  ``grad_x_matmul``
``conv[_fwd]``        (N, H, W, C, K, F)         ``fused_conv[_fwd]``
``conv_grad_w``       (N, H, W, C, K, F)         ``conv_grad_w``
``conv_grad_x``       (N, H, W, F, K, C)         ``conv_grad_x``
====================  =========================  =========================

What each backend can tune:

* ``reference``: the stream convs' band height ``bh`` (the default is
  ``conv_geometry``'s automatic band, as in the JAX package).  The
  matmuls and the materialise conv gradients have no knob.
* ``cuda``: nothing.  The kernels' tiles are compiled in and their
  split-K counts are planned per shape at launch, so every op returns
  ``(None, {})``, as the JAX package's reference matmuls do; the
  dispatchers still look every problem up and count it.

Kept from the JAX package on purpose: ``training_shapes`` lists no
``fuse_opt`` problem and ``tune()`` keys without ``fuse_opt``, so the
``fuse_opt`` lookups of #4 and #9 always miss.

Dispatchers are imported inside functions: they import :mod:`.state` at
module level, so an import here at module level would be circular.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

from .cache import TileCache, cache_key, dtype_name
from .measure import time_paired
from .tiles import TileConfig, conv_candidates

MATMUL_OPS = ("matmul", "matmul_fwd", "matmul_grad_w", "matmul_grad_x")
CONV_OPS = ("conv", "conv_fwd", "conv_grad_w", "conv_grad_x")
GRAD_OPS = ("matmul_grad_w", "matmul_grad_x", "conv_grad_w", "conv_grad_x")


class ParityError(AssertionError):
    """A candidate tile config changed kernel *results*: never acceptable."""


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _assert_parity(got, want, op: str, tiles) -> None:
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise ParityError(
                f"{op}: tiles {tiles} changed the result — tile choice "
                f"must be bitwise-invariant"
            )


def _operands(op: str, shape, dtype: str, seed: int, device: torch.device):
    """Integer operands for one tuning problem, from ``seed``."""
    x_dt, w_dt = (getattr(torch, s) for s in dtype.split(","))
    rng = np.random.default_rng(seed)

    def rand(shape, dt=torch.int32):
        v = rng.integers(-63, 64, shape, dtype=np.int64)
        return torch.from_numpy(v).to(device=device, dtype=dt)

    if op in ("matmul", "matmul_fwd"):
        m, k, n = shape
        return rand((m, k), x_dt), rand((k, n), w_dt)
    if op == "matmul_grad_w":
        b, m, n = shape  # x, delta, z_star
        return rand((b, m), x_dt), rand((b, n)), rand((b, n))
    if op == "matmul_grad_x":
        b, n, m = shape  # delta, z_star, w
        return rand((b, n)), rand((b, n)), rand((m, n), w_dt)
    if op in ("conv", "conv_fwd"):
        n, h, w, c, k, f = shape
        return rand((n, h, w, c), x_dt), rand((k, k, c, f), w_dt)
    if op == "conv_grad_w":
        n, h, w, c, k, f = shape  # x, delta, z_star (+k via shape)
        return rand((n, h, w, c), x_dt), rand((n, h, w, f)), rand((n, h, w, f))
    if op == "conv_grad_x":
        n, h, w, f, k, c = shape  # delta, z_star, weight
        return rand((n, h, w, f)), rand((n, h, w, f)), rand((k, k, c, f), w_dt)
    raise ValueError(f"unknown op {op!r}; one of {MATMUL_OPS + CONV_OPS}")


def _build(op: str, operands, *, shape, backend: str, conv_mode: str,
           fuse_bwd: bool, tiles):
    """A zero-argument callable running one dispatcher variant."""
    from repro_torch.core.scaling import conv_scale_factor, linear_scale_factor
    from repro_torch.kernels.nitro_conv import ops as conv_ops
    from repro_torch.kernels.nitro_matmul import ops as mm_ops
    from repro_torch.kernels.nitro_matmul.ref import masked_delta

    if op in ("matmul", "matmul_fwd"):
        x, w = operands
        entry = mm_ops.fused_matmul if op == "matmul" else mm_ops.fused_matmul_fwd
        return lambda: entry(x, w, sf=linear_scale_factor(x.shape[-1]), backend=backend,
                             tiles=tiles)
    if op == "matmul_grad_w":
        x, delta, z_star = operands
        return lambda: mm_ops.grad_w_matmul(x, delta, z_star, backend=backend, tiles=tiles)
    if op == "matmul_grad_x":
        delta, z_star, w = operands
        return lambda: mm_ops.grad_x_matmul(delta, z_star, w, backend=backend, tiles=tiles)
    if op in ("conv", "conv_fwd"):
        x, w = operands
        sf = conv_scale_factor(w.shape[0], x.shape[-1])
        entry = conv_ops.fused_conv if op == "conv" else conv_ops.fused_conv_fwd
        return lambda: entry(x, w, sf=sf, backend=backend, conv_mode=conv_mode, tiles=tiles)
    if op == "conv_grad_w":
        x, delta, z_star = operands
        k = shape[4]
        if not fuse_bwd:
            delta, z_star = masked_delta(delta, z_star, 10), None
        return lambda: conv_ops.conv_grad_w(
            x, delta, kernel_size=k, z_star=z_star, backend=backend,
            conv_mode=conv_mode, tiles=tiles)
    delta, z_star, w = operands  # conv_grad_x
    if not fuse_bwd:
        delta, z_star = masked_delta(delta, z_star, 10), None
    return lambda: conv_ops.conv_grad_x(delta, w, z_star=z_star, backend=backend,
                                        conv_mode=conv_mode, tiles=tiles)


def _untunable(op: str, backend: str, conv_mode: str) -> bool:
    # the CUDA kernels have no run-time knob; on the reference backend the
    # plain matmuls have none, and the materialise conv gradients are
    # plain int_matmul calls and its forward the (knobless) matmul
    return backend != "reference" or op in MATMUL_OPS or conv_mode == "materialise"


def _default_config(shape) -> TileConfig:
    """The tiles the dispatcher uses when the cache has no entry.

    The plain stream conv's untuned band height is ``conv_geometry``'s
    automatic choice (``min(H//2, 16)``), not ``DEFAULT_TILES.bh``: the
    probe must time what the fallback runs (only the reference stream
    convs get this far).
    """
    from repro_torch.kernels.nitro_conv.ref import conv_geometry

    h, k = shape[1], shape[4]  # K sits at index 4 in both conv layouts
    bh, _, _ = conv_geometry(h, k, None, pool=False)
    return TileConfig(bh=bh)


def _candidates(op: str, shape) -> list[TileConfig]:
    if op == "conv_grad_x":
        n, h, w, f, k, c = shape
        return conv_candidates(h, w, f, k, c)
    n, h, w, c, k, f = shape
    return conv_candidates(h, w, c, k, f)


def tune(
    op: str,
    shape,
    *,
    dtype: str = "int32,int32",
    backend: str = "auto",
    conv_mode: str = "stream",
    fuse_bwd: bool | None = None,
    cache: TileCache | None = None,
    iters: int = 5,
    seed: int = 0,
    device=DEFAULT_DEVICE,
) -> tuple[TileConfig | None, dict]:
    """Tune one problem on ``device``; returns ``(winner, {config: best_us})``.

    ``(None, {})`` means the combination has no knob (see the module
    docstring): its fallback is the only choice.
    """
    from repro_torch.kernels.nitro_matmul.ops import resolve_backend

    if op not in MATMUL_OPS + CONV_OPS:
        raise ValueError(f"unknown op {op!r}; one of {MATMUL_OPS + CONV_OPS}")
    device = resolve_device(device)
    backend = resolve_backend(backend, device)
    conv_mode = conv_mode if op in CONV_OPS else ""
    if fuse_bwd is None:
        fuse_bwd = op in GRAD_OPS
    if _untunable(op, backend, conv_mode):
        return None, {}
    operands = _operands(op, shape, dtype, seed, device)

    configs: dict[TileConfig, object] = {}
    for cfg in [_default_config(shape), *_candidates(op, shape)]:
        if cfg not in configs:
            configs[cfg] = _build(op, operands, shape=shape, backend=backend,
                                  conv_mode=conv_mode, fuse_bwd=fuse_bwd, tiles=cfg)

    # parity gate: every candidate reproduces the reference backend bitwise
    # before it may be timed
    want = _build(op, operands, shape=shape, backend="reference", conv_mode=conv_mode,
                  fuse_bwd=fuse_bwd, tiles=None)()
    for cfg, fn in configs.items():
        _assert_parity(fn(), want, op, cfg)

    times = time_paired(configs, iters=iters, device=device)
    winner = min(times, key=times.get)
    if cache is not None:
        cache.put(cache_key(op, shape, dtype, backend, conv_mode, fuse_bwd), winner)
    return winner, times


# ---------------------------------------------------------------------------
# Whole-model entry points
# ---------------------------------------------------------------------------


def plan_shapes(plan, batch: int) -> list[dict]:
    """The tuning problems an ``ExecutionPlan`` resolves, the JAX package's
    list for the same model and batch: the network input enters as int32,
    each step's output dtype is its meta's, the weight dtype the frozen
    one, and linear steps flatten whatever spatial shape precedes them."""
    problems = []
    shape = tuple(int(d) for d in plan.input_shape)
    act_dt = "int32"
    weights = getattr(plan, "frozen_weights", plan.weights)
    for w, meta in zip(weights, plan.metas):
        w_dt = dtype_name(w.dtype)
        if meta.kind == "conv":
            h, w_sp, c = shape
            k, f = meta.kernel_size, int(w.shape[-1])
            problems.append(dict(
                op="conv", shape=(batch, h, w_sp, c, k, f),
                dtype=f"{act_dt},{w_dt}", conv_mode=meta.conv_mode,
                fuse_bwd=False))
            shape = (h // 2, w_sp // 2, f) if meta.pool else (h, w_sp, f)
        else:
            feat = 1
            for d in shape:
                feat *= d
            problems.append(dict(
                op="matmul", shape=(batch, feat, int(w.shape[-1])),
                dtype=f"{act_dt},{w_dt}", conv_mode="", fuse_bwd=False))
            shape = (int(w.shape[-1]),)
        act_dt = meta.out_dtype
    return problems


def training_shapes(cfg, batch: int, *, conv_mode: str = "stream") -> list[dict]:
    """The fused forward/backward problems of one train step, the JAX
    package's list: each block's forward and both gradients (the learning
    and output layers run plain ``int_matmul``: no knob)."""
    problems = []
    shape = tuple(int(d) for d in cfg.input_shape)
    for spec in cfg.blocks:
        if spec.kind == "conv":
            h, w_sp, c = shape
            k, f = spec.kernel_size, spec.out_features
            problems += [
                dict(op="conv_fwd", shape=(batch, h, w_sp, c, k, f),
                     dtype="int32,int32", conv_mode=conv_mode, fuse_bwd=False),
                dict(op="conv_grad_w", shape=(batch, h, w_sp, c, k, f),
                     dtype="int32,int32", conv_mode=conv_mode, fuse_bwd=True),
                dict(op="conv_grad_x", shape=(batch, h, w_sp, f, k, c),
                     dtype="int32,int32", conv_mode=conv_mode, fuse_bwd=True),
            ]
            shape = (h // 2, w_sp // 2, f) if spec.pool else (h, w_sp, f)
        else:
            m = 1
            for d in shape:
                m *= d
            n = spec.out_features
            problems += [
                dict(op="matmul_fwd", shape=(batch, m, n),
                     dtype="int32,int32", conv_mode="", fuse_bwd=False),
                dict(op="matmul_grad_w", shape=(batch, m, n),
                     dtype="int32,int32", conv_mode="", fuse_bwd=True),
                dict(op="matmul_grad_x", shape=(batch, n, m),
                     dtype="int32,int32", conv_mode="", fuse_bwd=True),
            ]
            shape = (n,)
    return problems


def _tune_problems(problems, *, backend: str, cache: TileCache, iters: int,
                   seed: int, device) -> dict:
    from repro_torch.kernels.nitro_matmul.ops import resolve_backend

    device = resolve_device(device)
    backend = resolve_backend(backend, device)
    tuned = {}
    for p in problems:
        key = cache_key(p["op"], p["shape"], p["dtype"], backend,
                        p["conv_mode"], p["fuse_bwd"])
        if key in cache:
            tuned[key] = cache.get(key)  # measurement-free: already tuned
            continue
        winner, _ = tune(
            p["op"], p["shape"], dtype=p["dtype"], backend=backend,
            conv_mode=p["conv_mode"], fuse_bwd=p["fuse_bwd"], cache=cache,
            iters=iters, seed=seed, device=device)
        if winner is not None:
            tuned[key] = winner
    return tuned


def tune_plan(plan, batch: int, *, cache: TileCache, iters: int = 3,
              seed: int = 0) -> dict:
    """Tune every problem of one inference plan that the cache lacks, on
    the plan's device and backend; returns ``{cache_key: TileConfig}`` for
    the tunable ones.  Run it before serving: ``configure`` then makes the
    dispatchers find the winners."""
    return _tune_problems(plan_shapes(plan, batch), backend=plan.backend,
                          cache=cache, iters=iters, seed=seed, device=plan.device)


def tune_training(cfg, batch: int, *, cache: TileCache, backend: str = "auto",
                  conv_mode: str = "stream", iters: int = 3, seed: int = 0,
                  device=DEFAULT_DEVICE) -> dict:
    """Tune every fused forward/backward problem of one train config that
    the cache lacks, on ``device`` (the card unless told otherwise)."""
    return _tune_problems(
        training_shapes(cfg, batch, conv_mode=conv_mode), backend=backend,
        cache=cache, iters=iters, seed=seed, device=device)
