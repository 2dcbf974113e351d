"""Serving (port of ``repro.serving``' single-model path).

vision.py   VisionEngine: dynamic batching over one ExecutionPlan
stats.py    thread-safe EngineStats + nearest-rank latency percentiles

One model: ``compile_plan → VisionEngine``.
"""

from repro_torch.serving.stats import (  # noqa: F401
    EngineStats,
    latency_summary_ms,
    percentile,
    snapshot_delta,
)
from repro_torch.serving.vision import VisionEngine, VisionResult  # noqa: F401
