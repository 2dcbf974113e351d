"""Unified metrics registry: counters / gauges / histograms, one spine
(port of ``repro.obs.metrics``; pure Python, so the port keeps its own
copy).

Every host-side signal in the port — serving engine counters, queue
depths, batch fill, hot-swap events, benchmark summaries — lands in one
thread-safe ``MetricRegistry`` and leaves through two expositions:

  * ``prometheus_text()`` — the Prometheus text format (served over HTTP
    by ``MetricsServer`` for ``serve_vision --metrics-port``);
  * ``json_snapshot()`` / ``write_jsonl()`` — JSON for files and tests,
    with ``parse_jsonl()`` as the verified inverse (round-trip tested).

Metric families follow the Prometheus model: a family has a name, a
kind, and a fixed tuple of label names; ``family.labels(model="a")``
returns (creating on first use) the child carrying one label-value
combination.  Families without labels proxy their operations straight to
a default child, so ``registry.counter("x").inc()`` just works.

All mutation and reading happens under one registry-wide re-entrant
lock.  That makes multi-metric updates atomic for free: a caller that
holds ``registry.lock`` across several ``inc``/``observe`` calls (as
``serving.stats.EngineStats.record_batch`` does) can never be observed
half-applied by a concurrent ``snapshot()``.  Contention is per *batch*,
not per request — negligible next to a device launch.

This module also owns the nearest-rank percentile helpers the serving
stack reports (``serving.stats`` re-exports them): the q-th percentile
of n samples is the ``max(ceil(q·n), 1)``-th smallest — exact at the
``q=1.0`` and small-n boundaries.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

#: Repo version reported by ``repro_build_info`` (the JAX package's: the
#: two packages are one repo at one version).
REPRO_VERSION = "0.8.0"

# Stamped at first import — the closest observable to process start
# without a psutil dependency; good to well under a second, which is
# all an uptime panel needs.
_PROCESS_START_S = time.time()

# Percentiles every serving surface reports, as (label, quantile).
PERCENTILES = (("p50", 0.50), ("p90", 0.90), ("p95", 0.95), ("p99", 0.99))

# Default histogram bucket upper bounds, in seconds (latency-shaped).
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


def percentile(sorted_vals, q: float):
    """Nearest-rank percentile of an ascending-sorted sequence.

    The q-th percentile of n samples is the ``max(ceil(q·n), 1)``-th
    smallest value (0.0 on an empty sequence).  Note the former
    floor-rank implementation was off by one whenever ``q·n`` was an
    integer — e.g. the median of 4 samples returned the 3rd.
    """
    n = len(sorted_vals)
    if not n:
        return 0.0
    rank = min(max(math.ceil(q * n), 1), n)
    return sorted_vals[rank - 1]


def latency_summary_ms(latencies_s) -> dict[str, float]:
    """Unsorted per-request latencies in seconds → {p50,p90,p95,p99} in ms."""
    lats = sorted(latencies_s)
    return {label: percentile(lats, q) * 1e3 for label, q in PERCENTILES}


class MetricError(ValueError):
    """Metric registration/usage conflict (name, kind, or labels)."""


def _check_name(name: str) -> None:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise MetricError(f"bad metric name {name!r}")


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _format_labels(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


# ---------------------------------------------------------------------------
# Children — one label-value combination of a family
# ---------------------------------------------------------------------------


class _CounterChild:
    def __init__(self, lock):
        self._lock = lock
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise MetricError("counters only go up (use a gauge)")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class _GaugeChild:
    def __init__(self, lock):
        self._lock = lock
        self._value = 0

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        self.inc(-n)

    @property
    def value(self):
        with self._lock:
            return self._value


class _HistogramChild:
    """Cumulative buckets + sum/count, plus a bounded sample window.

    The window is what serving snapshots compute nearest-rank
    percentiles from (Prometheus quantiles are server-side; our JSON
    views want them inline) — bounded so a long-lived engine never grows
    host memory per observation.
    """

    def __init__(self, lock, bounds, window: int):
        self._lock = lock
        self.bounds = bounds
        self._bucket_counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self.window: deque = deque(maxlen=window)

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
            self._sum += v
            self._count += 1
            self.window.append(v)

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """[(upper_bound, cumulative_count)], ending with (+inf, count)."""
        with self._lock:
            counts = list(self._bucket_counts)
        acc, out = 0, []
        for ub, c in zip((*self.bounds, math.inf), counts):
            acc += c
            out.append((ub, acc))
        return out

    def percentiles(self) -> dict[str, float]:
        """Nearest-rank percentiles over the bounded sample window."""
        with self._lock:
            vals = sorted(self.window)
        return {label: percentile(vals, q) for label, q in PERCENTILES}


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild}


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------


class _Family:
    """One named metric family: fixed kind + label names, many children."""

    def __init__(self, registry: "MetricRegistry", kind: str, name: str,
                 help: str, label_names: tuple[str, ...], **child_kw):
        self._registry = registry
        self._lock = registry.lock
        self._child_kw = child_kw
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, **kv):
        """The child for one label-value combination (created on first use)."""
        if sorted(kv) != sorted(self.label_names):
            raise MetricError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}"
            )
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _CHILD_TYPES[self.kind](self._lock, **self._child_kw)
                self._children[key] = child
        return child

    def _default(self):
        if self.label_names:
            raise MetricError(
                f"{self.name} declares labels {self.label_names}; "
                f"use .labels(...)"
            )
        return self.labels()

    # Label-less convenience proxies.
    def inc(self, n=1):
        self._default().inc(n)

    def dec(self, n=1):
        self._default().dec(n)

    def set(self, v):
        self._default().set(v)

    def observe(self, v):
        self._default().observe(v)

    @property
    def value(self):
        return self._default().value

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # ---- exposition -------------------------------------------------------

    def prometheus_lines(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for values, child in self.children():
            lbl = _format_labels(self.label_names, values)
            if self.kind == "histogram":
                for ub, cum in child.cumulative_buckets():
                    le = "+Inf" if math.isinf(ub) else repr(ub)
                    blbl = _format_labels((*self.label_names, "le"),
                                          (*values, le))
                    lines.append(f"{self.name}_bucket{blbl} {cum}")
                lines.append(f"{self.name}_sum{lbl} {child.sum}")
                lines.append(f"{self.name}_count{lbl} {child.count}")
            else:
                lines.append(f"{self.name}{lbl} {child.value}")
        return lines

    def json_sample(self, values, child) -> dict:
        sample = {"labels": dict(zip(self.label_names, values))}
        if self.kind == "histogram":
            sample.update(
                count=child.count, sum=child.sum,
                buckets=[[ub if not math.isinf(ub) else "+Inf", cum]
                         for ub, cum in child.cumulative_buckets()],
            )
        else:
            sample["value"] = child.value
        return sample

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "help": self.help,
            "label_names": list(self.label_names),
            "samples": [self.json_sample(v, c) for v, c in self.children()],
        }


class Counter(_Family):
    pass


class Gauge(_Family):
    pass


class Histogram(_Family):
    pass


_FAMILY_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class MetricRegistry:
    """Thread-safe name → metric-family table with pluggable exposition."""

    def __init__(self):
        self.lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, kind: str, name: str, help: str,
                       labels, **child_kw) -> _Family:
        _check_name(name)
        labels = tuple(labels)
        with self.lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _FAMILY_TYPES[kind](self, kind, name, help, labels,
                                          **child_kw)
                self._families[name] = fam
                return fam
        # Re-registration is idempotent only for an identical declaration.
        if fam.kind != kind or fam.label_names != labels:
            raise MetricError(
                f"metric {name!r} already registered as {fam.kind}"
                f"{fam.label_names}, requested {kind}{labels}"
            )
        if child_kw and fam._child_kw != child_kw:
            raise MetricError(
                f"metric {name!r} re-registered with different options"
            )
        return fam

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get_or_create("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=DEFAULT_BUCKETS, window: int = 1024) -> Histogram:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise MetricError(f"histogram {name!r} needs at least one bucket")
        return self._get_or_create("histogram", name, help, labels,
                                   bounds=bounds, window=window)

    def families(self) -> list[_Family]:
        with self.lock:
            return [self._families[n] for n in sorted(self._families)]

    def __contains__(self, name: str) -> bool:
        with self.lock:
            return name in self._families

    # ---- exposition -------------------------------------------------------

    def prometheus_text(self) -> str:
        lines = []
        for fam in self.families():
            lines.extend(fam.prometheus_lines())
        return "\n".join(lines) + "\n"

    def json_snapshot(self) -> dict:
        return {fam.name: fam.to_json() for fam in self.families()}

    def write_jsonl(self, path: str) -> None:
        """One JSON line per family — ``parse_jsonl`` is the inverse."""
        with open(path, "w") as f:
            for fam in self.families():
                f.write(json.dumps(fam.to_json(), sort_keys=True) + "\n")

    @staticmethod
    def parse_jsonl(text: str) -> dict:
        """Parse ``write_jsonl`` output back into a ``json_snapshot`` dict."""
        out = {}
        for line in text.splitlines():
            if line.strip():
                fam = json.loads(line)
                out[fam["name"]] = fam
        return out


def register_build_info(registry: MetricRegistry, *,
                        backend: str = "unknown",
                        version: str = REPRO_VERSION) -> None:
    """Register the standard process-identity metrics on ``registry``.

    ``repro_build_info{version,backend} 1`` — the Prometheus *info*
    idiom: a constant-1 gauge whose labels carry the identity, so
    dashboards can join any series against "which build/backend answered
    this scrape".  ``process_start_time_seconds`` (unix epoch) gives
    uptime for free as ``time() - process_start_time_seconds``.  Both
    are idempotent; every scrape surface (``serve_vision``,
    ``launch/train --metrics-port``) calls this before serving.  The
    port passes the resolved device type (``"cuda"`` or ``"cpu"``) as
    ``backend``.
    """
    registry.gauge(
        "repro_build_info",
        "constant 1; labels carry the repo version and device backend",
        labels=("version", "backend"),
    ).labels(version=version, backend=backend).set(1)
    registry.gauge(
        "process_start_time_seconds",
        "unix time this process imported repro_torch.obs.metrics",
    ).set(_PROCESS_START_S)


# ---------------------------------------------------------------------------
# HTTP exposition (Prometheus scrape endpoint)
# ---------------------------------------------------------------------------


class MetricsServer:
    """Tiny threaded HTTP server exposing one registry.

    ``GET /metrics`` → Prometheus text; ``GET /metrics.json`` → the JSON
    snapshot; ``GET /healthz`` → ``ok`` (a liveness probe that answers
    while the worker thread still schedules requests — what container
    orchestration and the obs_top dashboard poll).  ``port=0`` binds an
    ephemeral port (read it back from ``.port`` — what the tests and
    ``--metrics-port 0`` use).
    """

    def __init__(self, registry: MetricRegistry, *, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry

        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                if self.path == "/metrics":
                    body = server.registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/metrics.json":
                    body = json.dumps(server.registry.json_snapshot(),
                                      sort_keys=True).encode()
                    ctype = "application/json"
                elif self.path == "/healthz":
                    body = b"ok\n"
                    ctype = "text/plain; charset=utf-8"
                else:
                    self.send_error(404, "unknown path (try /metrics)")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_metrics_server(registry: MetricRegistry, *, port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Start serving ``registry`` on ``host:port`` (0 = ephemeral)."""
    return MetricsServer(registry, port=port, host=host)
