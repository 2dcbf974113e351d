"""Serving statistics: latency percentiles, thread-safe counters and the
SLO vocabulary (port of ``repro.serving.stats``; the percentile helpers
copy ``repro.obs.metrics``).

``EngineStats`` keeps the JAX package's ``snapshot()`` keys and read
properties.  It is written from the engine's worker thread while clients
read it, so every update and every snapshot holds one lock: a snapshot
never sees half a batch.

``Slo(deadline_ms)`` is the per-model objective a ``ModelEntry`` carries;
``slo_summary`` is the per-arm p99-vs-SLO roll-up.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass

PERCENTILES = (("p50", 0.50), ("p90", 0.90), ("p95", 0.95), ("p99", 0.99))

# Metric-family names of the serving counters (the JAX package registers
# them; the port names them only, until its metric registry exists).
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


def percentile(sorted_vals, q: float):
    """Nearest-rank percentile of an ascending-sorted sequence: the
    ``max(ceil(q·n), 1)``-th smallest value (0.0 when empty)."""
    n = len(sorted_vals)
    if not n:
        return 0.0
    rank = min(max(math.ceil(q * n), 1), n)
    return sorted_vals[rank - 1]


def latency_summary_ms(latencies_s) -> dict[str, float]:
    """Unsorted per-request latencies in seconds → {p50,p90,p95,p99} in ms."""
    lats = sorted(latencies_s)
    return {label: percentile(lats, q) * 1e3 for label, q in PERCENTILES}


@dataclass(frozen=True)
class Slo:
    """A per-model serving objective: answer within ``deadline_ms``.

    Attached to a ``ModelEntry`` (``ModelRegistry.register(..., slo=)`` or
    ``set_slo``); ``FleetEngine`` then counts every delivered request
    whose end-to-end latency passed the deadline (negative slack).
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
    """Thread-safe per-engine (or per-model) serving counters."""

    def __init__(self, *, latency_window: int = 1024):
        self._lock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._padded = 0
        # bounded window: a long-lived engine must not grow host memory
        self._latency: deque[float] = deque(maxlen=latency_window)

    def record_batch(self, n: int, padded: int, latency_s: float) -> None:
        with self._lock:
            self._requests += n
            self._batches += 1
            self._padded += padded
            self._latency.append(latency_s)

    @property
    def requests(self) -> int:
        return self._requests

    @property
    def batches(self) -> int:
        return self._batches

    @property
    def padded_slots(self) -> int:
        return self._padded

    @property
    def batch_latency_s(self):
        """The bounded latency-sample window (read-only view)."""
        with self._lock:
            return tuple(self._latency)

    @property
    def avg_batch_fill(self) -> float:
        with self._lock:
            requests, padded = self._requests, self._padded
        total = requests + padded
        return requests / total if total else 0.0

    def snapshot(self) -> dict:
        """Consistent JSON-ready view: counters + batch-latency percentiles."""
        with self._lock:
            requests, batches, padded = self._requests, self._batches, self._padded
            lats = list(self._latency)
        total = requests + padded
        return {
            "requests": requests,
            "batches": batches,
            "padded_slots": padded,
            "avg_batch_fill": requests / total if total else 0.0,
            "batch_latency_ms": latency_summary_ms(lats),
        }
