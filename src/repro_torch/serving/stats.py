"""Serving statistics: latency percentiles + thread-safe counters (port of
``repro.serving.stats``; the percentile helpers copy ``repro.obs.metrics``).

``EngineStats`` keeps the JAX package's ``snapshot()`` keys.  It is
written from the engine's worker thread while clients read it, so every
update and every snapshot holds one lock: a snapshot never sees half a
batch.
"""

from __future__ import annotations

import math
import threading
from collections import deque

PERCENTILES = (("p50", 0.50), ("p90", 0.90), ("p95", 0.95), ("p99", 0.99))


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


class EngineStats:
    """Thread-safe per-engine serving counters."""

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
