"""repro_torch.obs — the observability spine (port of ``repro.obs``).

telemetry.py  integer-only reductions computed alongside
              ``les.train_step(telemetry=True)``: per-layer bit-occupancy
              histograms, saturation counts, NITRO-ReLU dead units,
              optimiser scalars — bitwise-neutral to the trajectory
metrics.py    thread-safe MetricRegistry (counters/gauges/histograms,
              Prometheus-text + JSONL exposition, HTTP scrape server)
              — the spine ``serving.stats.EngineStats`` is built on
trace.py      monotonic-clock span tracer with thread-local nesting,
              JSONL export, optional ``torch.profiler.record_function``
              bridge, and one active tracer a process (``use`` /
              ``active``) that the port's layers record into — the step
              (``step.*``), blocks (``blocks.*``), dispatchers
              (``dispatch.*``), CUDA wrappers (``kernel.*``), plan
              (``plan.*``) and exchange (``parallel.*``) — beside the CLI
              loop's ``train.*`` and the FleetEngine batch lifecycle;
              ``Tracer.anchor`` puts spans on a profiler trace's clock
health.py     training-health rule engine over the telemetry records:
              saturation trends, int32 headroom, dead-unit growth,
              optimiser-scalar stall — windowed, hysteretic,
              edge-triggered alerts fanned out to sinks and
              ``obs_alerts_total`` counters; online in launch/train.py
              or offline over any metrics.jsonl (``scan_jsonl``)

``telemetry`` imports torch and is not re-exported here; the other three
are pure Python.
"""

from repro_torch.obs.health import (
    SEVERITIES,
    Alert,
    DeadUnitGrowthRule,
    DpCompressFitRule,
    HeadroomRule,
    HealthMonitor,
    OptimizerStallRule,
    Rule,
    SaturationTrendRule,
    default_rules,
    jsonl_sink,
    print_sink,
    scan_jsonl,
)
from repro_torch.obs.metrics import (
    REPRO_VERSION,
    MetricError,
    MetricRegistry,
    MetricsServer,
    latency_summary_ms,
    percentile,
    register_build_info,
    start_metrics_server,
)
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer

__all__ = [
    "Alert",
    "DeadUnitGrowthRule",
    "DpCompressFitRule",
    "HeadroomRule",
    "HealthMonitor",
    "MetricError",
    "MetricRegistry",
    "MetricsServer",
    "NULL_TRACER",
    "OptimizerStallRule",
    "REPRO_VERSION",
    "Rule",
    "SEVERITIES",
    "SaturationTrendRule",
    "Span",
    "Tracer",
    "default_rules",
    "jsonl_sink",
    "latency_summary_ms",
    "percentile",
    "print_sink",
    "register_build_info",
    "scan_jsonl",
    "start_metrics_server",
]
