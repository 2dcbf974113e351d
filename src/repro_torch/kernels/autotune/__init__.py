"""Per-shape autotuning of the kernels' run-time knobs (port of
``repro.kernels.autotune``).

``tiles``    ``TileConfig`` (the JAX package's fields) and the candidate
             spaces: the plain stream conv's band height (the CUDA
             kernels have no run-time knob: their tiles are compiled in).
``measure``  the ABBA min-of-N paired timing harness (CUDA events on the
             card, ``perf_counter`` on the CPU).
``cache``    the on-disk JSON cache: the JAX package's key strings and a
             build fingerprint (port version, torch, CUDA, card, nvcc);
             flock-merged atomic writes, corruption-tolerant reads.
``state``    process-wide resolution: ``configure`` a cache, dispatchers
             call ``resolve_tiles`` per launch (remembered per key until
             the next ``configure``); hit/miss counters and the int8-path
             gauge on a ``MetricRegistry``.
``search``   the measured tuner: candidates → bitwise parity gate → one
             paired-timing session → argmin → cache; and the whole-model
             entry points ``tune_plan`` / ``tune_training``.

A tile choice changes speed only: integer sums are exact in any order, so
every accepted config gives bitwise the same outputs (parity-gated at tune
time, held in ``tests/test_torch_autotune.py`` and on the card).
"""

from repro_torch.kernels.autotune.cache import (
    CACHE_FILENAME,
    TileCache,
    build_fingerprint,
    cache_key,
)
from repro_torch.kernels.autotune.measure import time_fn, time_paired
from repro_torch.kernels.autotune.search import (
    ParityError,
    plan_shapes,
    training_shapes,
    tune,
    tune_plan,
    tune_training,
)
from repro_torch.kernels.autotune.state import (
    active_cache,
    configure,
    note_int8_path,
    resolve_tiles,
    set_metrics,
)
from repro_torch.kernels.autotune.tiles import (
    DEFAULT_TILES,
    TileConfig,
    conv_candidates,
    matmul_candidates,
)

__all__ = [
    "CACHE_FILENAME",
    "DEFAULT_TILES",
    "ParityError",
    "TileCache",
    "TileConfig",
    "active_cache",
    "build_fingerprint",
    "cache_key",
    "configure",
    "conv_candidates",
    "matmul_candidates",
    "note_int8_path",
    "plan_shapes",
    "resolve_tiles",
    "set_metrics",
    "time_fn",
    "time_paired",
    "training_shapes",
    "tune",
    "tune_plan",
    "tune_training",
]
