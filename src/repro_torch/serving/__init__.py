"""Serving (port of ``repro.serving``' vision half).

vision.py    VisionEngine: the static dynamic-batching scheduler over one
             ExecutionPlan
stats.py     thread-safe EngineStats over repro_torch.obs.MetricRegistry,
             re-exported nearest-rank latency percentiles and the SLO
             vocabulary (Slo, slo_summary)
registry.py  ModelRegistry: many FrozenModels compiled and hot-swapped
             under stable model ids, shared padding buffers; pass
             metrics= for scrapeable per-model counters + swap events
fleet.py     FleetEngine: continuous (double-buffered) batching over every
             registered model — per-model queues, weighted round-robin,
             page-locked staging on the card — and the deterministic A/B
             Router; queue-depth / batch-fill metrics and per-phase
             tracer spans

One model, simplest path:  compile_plan → VisionEngine.
A fleet of models:         ModelRegistry → FleetEngine (+ Router splits).
"""

from repro_torch.serving.fleet import FleetEngine, Router, parse_split  # noqa: F401
from repro_torch.serving.registry import ModelEntry, ModelRegistry  # noqa: F401
from repro_torch.serving.stats import (  # noqa: F401
    EngineStats,
    Slo,
    fleet_snapshot_delta,
    latency_summary_ms,
    percentile,
    slo_summary,
    snapshot_delta,
)
from repro_torch.serving.vision import VisionEngine, VisionResult  # noqa: F401

__all__ = sorted([
    "EngineStats", "FleetEngine", "ModelEntry", "ModelRegistry", "Router",
    "Slo", "VisionEngine", "VisionResult", "fleet_snapshot_delta",
    "latency_summary_ms", "parse_split", "percentile", "slo_summary",
    "snapshot_delta",
])
