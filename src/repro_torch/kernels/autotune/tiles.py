"""Tile configurations and the per-shape candidate search space (port of
``repro.kernels.autotune.tiles``).

One ``TileConfig`` describes every knob the dispatchers pass down: the
JAX package's fields ``bm / bn / bk / bh / bf`` and their defaults, kept so
that a cache entry reads the same in both packages.  On this port only
``bh`` does anything: it is the plain stream conv's row-band height
(``nitro_conv.ref.conv_geometry``).  The CUDA kernels' tiles are
compile-time constants (the matmuls' 64 × 64, ``digit_gemm.cuh``'s
128 × 64) and their split-K counts are planned per shape at launch
(``plan_splits``), so no field has a run-time meaning on the card: a
compiled tile variant is what a later candidate would add here.

Stdlib only, so every kernel package can import it without cycles.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One complete tiling choice for the fused kernel family."""

    bm: int = 128
    bn: int = 128
    bk: int = 128
    bh: int = 8
    bf: int = 128

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TileConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        vals = {k: int(v) for k, v in d.items() if k in fields}
        cfg = cls(**vals)
        for f in dataclasses.fields(cls):
            if getattr(cfg, f.name) < 1:
                raise ValueError(f"tile {f.name} must be >= 1, got {cfg}")
        return cfg


#: What every dispatcher falls back to.
DEFAULT_TILES = TileConfig()


def _clamped(candidates, dim: int) -> list[int]:
    """Clamp candidate tile sizes to the problem dimension, dedup by the
    clamped value, keep the order."""
    seen: dict[int, None] = {}
    for v in candidates:
        seen.setdefault(max(1, min(v, dim)), None)
    return list(seen)


def matmul_candidates(m: int, k: int, n: int) -> list[TileConfig]:
    """The matmul tile candidates: the defaults alone (the port's matmul
    tiles are compiled in)."""
    return [DEFAULT_TILES]


def conv_candidates(h: int, w: int, c: int, kernel_size: int,
                    f: int) -> list[TileConfig]:
    """Band heights for the plain stream conv over (H, W, C) with K×K
    filters and F outputs: the defaults first, then ``bh`` in 2, 4, 8, 16,
    32 clamped to H (the JAX package's axis; ``conv_geometry`` evens a band
    under a fused pool)."""
    out = [DEFAULT_TILES]
    for bh in _clamped((2, 4, 8, 16, 32), h):
        if bh != DEFAULT_TILES.bh:
            out.append(TileConfig(bh=bh))
    return out
