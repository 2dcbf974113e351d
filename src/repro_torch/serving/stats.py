"""Serving statistics: latency percentiles, thread-safe counters and the
SLO vocabulary (port of ``repro.serving.stats``).

The serving-facing veneer over ``obs.metrics``: the percentile helpers
are re-exported from there (one nearest-rank implementation for the whole
port) and ``EngineStats`` is built on a ``MetricRegistry`` — the same
counters ``serve_vision --metrics-port`` exposes as Prometheus text.

``EngineStats`` has two modes:

  * standalone (default): a private registry per instance;
  * shared: pass ``registry=`` + ``labels=`` and the counters become
    children of the shared families (``serve_requests_total{model=…}``
    etc.), which is how ``ModelRegistry`` folds every model's stats into
    one scrapeable registry.

It is written from an engine's worker thread while clients read it:
``record_batch`` holds the registry lock across all its updates (one
acquisition per batch), so ``snapshot()``, which takes the same lock,
never sees half a batch.

``Slo(deadline_ms)`` is the per-model objective a ``ModelEntry`` carries;
``slo_summary`` is the per-arm p99-vs-SLO roll-up, and the
``serve_request_deadline_seconds`` / ``serve_slo_violations_total``
family names are what the fleet engine records under.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs.metrics import (  # noqa: F401 — re-exported here
    PERCENTILES,
    MetricRegistry,
    latency_summary_ms,
    percentile,
)

# Metric-family names EngineStats registers (shared across every scope).
REQUESTS_TOTAL = "serve_requests_total"
BATCHES_TOTAL = "serve_batches_total"
PADDED_SLOTS_TOTAL = "serve_padded_slots_total"
BATCH_LATENCY_SECONDS = "serve_batch_latency_seconds"

# SLO-attribution families (FleetEngine, per ``model`` label).
REQUEST_DEADLINE_SECONDS = "serve_request_deadline_seconds"
SLO_VIOLATIONS_TOTAL = "serve_slo_violations_total"
SLO_DEADLINE_SECONDS = "serve_slo_deadline_seconds"

# Deadline-slack buckets (seconds): symmetric around 0 so the violating
# tail (negative slack = missed deadline) is as resolvable as the
# healthy side.
SLACK_BUCKETS = (-1.0, -0.25, -0.1, -0.05, -0.01, 0.0,
                 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


@dataclass(frozen=True)
class Slo:
    """A per-model serving objective: answer within ``deadline_ms``.

    Attached to a ``ModelEntry`` (``ModelRegistry.register(..., slo=)`` or
    ``set_slo``); ``FleetEngine`` then records every delivered request's
    deadline slack (``deadline − end-to-end latency``, seconds; negative
    = violation) into ``serve_request_deadline_seconds{model=…}`` and
    counts misses in ``serve_slo_violations_total{model=…}``.
    """

    deadline_ms: float

    def __post_init__(self):
        if not self.deadline_ms > 0:
            raise ValueError(f"Slo deadline must be > 0 ms, "
                             f"got {self.deadline_ms!r}")

    @property
    def deadline_s(self) -> float:
        return self.deadline_ms / 1e3

    def slack_s(self, latency_s: float) -> float:
        """Signed headroom of one answered request (negative = missed)."""
        return self.deadline_s - latency_s


def slo_summary(latencies_s, slo: Slo | None) -> dict:
    """Per-arm p99-vs-SLO roll-up of end-to-end request latencies (s);
    with no SLO only the p99 is reported."""
    lats = sorted(latencies_s)
    p99_ms = percentile(lats, 0.99) * 1e3
    out = {"p99_ms": p99_ms, "slo_ms": None}
    if slo is not None:
        violations = sum(1 for v in lats if v > slo.deadline_s)
        out.update(
            slo_ms=slo.deadline_ms,
            p99_slack_ms=slo.deadline_ms - p99_ms,
            slo_violations=violations,
            violation_frac=violations / len(lats) if lats else 0.0,
            meets_slo=p99_ms <= slo.deadline_ms,
        )
    return out


def snapshot_delta(pre: dict, post: dict) -> dict:
    """Counter difference of two ``EngineStats.snapshot()`` views (the
    batch-latency percentiles are not diffable and are omitted)."""
    requests = post["requests"] - pre["requests"]
    padded = post["padded_slots"] - pre["padded_slots"]
    total = requests + padded
    return {
        "requests": requests,
        "batches": post["batches"] - pre["batches"],
        "padded_slots": padded,
        "avg_batch_fill": requests / total if total else 0.0,
    }


def fleet_snapshot_delta(pre: dict, post: dict) -> dict:
    """Delta of two ``FleetEngine.snapshot()`` views (fleet + per-model).

    A model registered after ``pre`` was taken is deltaed against zero.
    """
    zero = {"requests": 0, "batches": 0, "padded_slots": 0}
    return {
        "fleet": snapshot_delta(pre["fleet"], post["fleet"]),
        "models": {
            mid: snapshot_delta(pre["models"].get(mid, zero), m)
            for mid, m in post["models"].items()
        },
    }


class EngineStats:
    """Thread-safe per-engine (or per-model) serving counters, backed by
    ``obs.metrics`` families; ``snapshot()`` holds the lock
    ``record_batch`` writes under, so it never sees half a batch."""

    def __init__(self, *, latency_window: int = 1024,
                 registry: MetricRegistry | None = None,
                 labels: dict[str, str] | None = None):
        if registry is None and labels:
            raise ValueError("labels require a shared registry")
        self.registry = registry or MetricRegistry()
        labels = dict(labels or {})
        names = tuple(sorted(labels))
        reg = self.registry
        self._requests = reg.counter(
            REQUESTS_TOTAL, "requests answered", labels=names).labels(**labels)
        self._batches = reg.counter(
            BATCHES_TOTAL, "device batches launched", labels=names,
        ).labels(**labels)
        self._padded = reg.counter(
            PADDED_SLOTS_TOTAL, "zero-padded batch slots", labels=names,
        ).labels(**labels)
        # bounded window: a long-lived engine must not grow host memory
        self._latency = reg.histogram(
            BATCH_LATENCY_SECONDS, "per-batch device latency", labels=names,
            window=latency_window,
        ).labels(**labels)

    def record_batch(self, n: int, padded: int, latency_s: float) -> None:
        with self.registry.lock:  # re-entrant: one atomic multi-metric update
            self._requests.inc(n)
            self._batches.inc()
            self._padded.inc(padded)
            self._latency.observe(latency_s)

    @property
    def requests(self) -> int:
        return self._requests.value

    @property
    def batches(self) -> int:
        return self._batches.value

    @property
    def padded_slots(self) -> int:
        return self._padded.value

    @property
    def batch_latency_s(self):
        """The bounded latency-sample window (read-only view)."""
        with self.registry.lock:
            return tuple(self._latency.window)

    @property
    def avg_batch_fill(self) -> float:
        with self.registry.lock:
            requests, padded = self._requests.value, self._padded.value
        total = requests + padded
        return requests / total if total else 0.0

    def snapshot(self) -> dict:
        """Consistent JSON-ready view: counters + batch-latency percentiles."""
        with self.registry.lock:
            requests = self._requests.value
            batches = self._batches.value
            padded = self._padded.value
            lats = list(self._latency.window)
        total = requests + padded
        return {
            "requests": requests,
            "batches": batches,
            "padded_slots": padded,
            "avg_batch_fill": requests / total if total else 0.0,
            "batch_latency_ms": latency_summary_ms(lats),
        }
