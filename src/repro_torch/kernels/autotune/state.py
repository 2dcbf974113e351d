"""Process-wide autotune state: the active cache and the metric hooks (port
of ``repro.kernels.autotune.state``).

The dispatchers (``nitro_matmul/ops.py``, ``nitro_conv/ops.py``) call
:func:`resolve_tiles` on every launch they make with ``tiles=None``:

* no cache configured → ``None`` after one global read: no key string is
  built and no lock is taken (the kernels use their own split plan, the
  plain conv its automatic band);
* cache configured, key present → the tuned :class:`TileConfig`
  (``kernel_tile_cache_hits_total`` + 1);
* cache configured, key absent → ``None`` (``kernel_tile_cache_misses_total``
  + 1).  Resolution never tunes: only :mod:`.search` measures.

The JAX dispatchers resolve once per jit trace; this port runs eagerly and
would resolve on every launch, on a host path that already bounds the
card.  So each key's resolution is remembered until the next
:func:`configure`: a repeated launch costs one dict lookup, and the
counters count a key's first resolution, which is what a JAX trace sees.
"""

from __future__ import annotations

import threading

from .cache import TileCache, cache_key
from .tiles import TileConfig

_active_cache: TileCache | None = None
_metrics = None  # (hits counter, misses counter, int8 gauge) or None
_memo: dict = {}   # resolve_tiles' arguments, and key strings → TileConfig | None
_lock = threading.Lock()


def configure(cache: "TileCache | str | None", *, device=None) -> TileCache | None:
    """Install (or clear, with ``None``) the process-wide tile cache: a
    ``TileCache`` or a path (directory or file) to open one at, with the
    fingerprint of ``device``.  Forgets every remembered resolution.
    Returns the installed cache."""
    global _active_cache
    with _lock:
        if cache is None or isinstance(cache, TileCache):
            _active_cache = cache
        else:
            _active_cache = TileCache(cache, device=device)
        _memo.clear()
    return _active_cache


def active_cache() -> TileCache | None:
    return _active_cache


def set_metrics(registry) -> None:
    """Register the autotune metric families on a ``MetricRegistry``
    (``None`` detaches them, the default)."""
    global _metrics
    if registry is None:
        _metrics = None
        return
    _metrics = (
        registry.counter(
            "kernel_tile_cache_hits_total",
            "Tile resolutions served from the autotune cache"),
        registry.counter(
            "kernel_tile_cache_misses_total",
            "Tile resolutions that fell back to DEFAULT_TILES"),
        registry.gauge(
            "kernel_int8_path_active",
            "1 when a plan step multiplies int8 operands, else 0",
            labels=("layer",)),
    )


def note_int8_path(layer: str, active: bool) -> None:
    """Record whether ``layer`` took the int8-operand path (gauge)."""
    if _metrics is not None:
        _metrics[2].labels(layer=str(layer)).set(int(active))


def resolve_tiles(op: str, shape, *, dtype, backend: str, conv_mode: str = "",
                  fuse_bwd: bool = False, fuse_opt: bool = False) -> TileConfig | None:
    """The tuned tiles for one problem, or ``None`` for the defaults.

    ``dtype`` is the key's ``"x,w"`` string or a pair of torch dtypes;
    ``shape`` a tuple of ints."""
    cache = _active_cache
    if cache is None:
        return None
    args = (op, shape, dtype, backend, conv_mode, fuse_bwd, fuse_opt)
    try:
        return _memo[args]
    except KeyError:
        pass
    with _lock:
        cache = _active_cache  # configure() may have run meanwhile
        if cache is None:
            return None
        if args in _memo:
            return _memo[args]
        key = cache_key(op, shape, dtype, backend, conv_mode, fuse_bwd, fuse_opt)
        counted = key in _memo  # the same key reached with other arguments
        tiles = _memo[key] if counted else cache.get(key)
        if not counted:
            _memo[key] = tiles
            if _metrics is not None:
                _metrics[0 if tiles is not None else 1].inc()
        _memo[args] = tiles
    return tiles
