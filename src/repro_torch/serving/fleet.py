"""Fleet serving: continuous batching + A/B routing over a ModelRegistry
(port of ``repro.serving.fleet``).

The static ``VisionEngine`` serialises host and device work: wait
``max_wait_ms`` → stack → launch → block on results → repeat, leaving the
card idle during every host phase.  ``FleetEngine`` replaces that loop
with a **continuous, double-buffered scheduler** over every model in a
``ModelRegistry``:

  * requests land on bounded **per-model queues** (submit blocks when a
    model's queue is full);
  * one worker drains the queues with **smooth weighted round-robin**;
  * the worker keeps **one batch in flight on the card while assembling
    the next on the host**: the in-flight batch is the wait timer, and a
    queue that reaches ``batch_size`` mid-flight is stacked and padded
    while the card still computes.  From idle, a request launches after
    at most one coalescing window (``coalesce_ms``).

On a CUDA plan the dispatch returns before the card finishes: the worker
stacks each batch into one of two **page-locked host slots** per batch
shape, used in turn, copies it to the card with ``non_blocking=True`` on
its current stream and runs the plan on the device tensor.  A slot is
overwritten only after the event recorded behind its last copy has
completed, so assembling batch N+1 never touches batch N's bytes in
flight.  The fetch (``logits.cpu()``) is the loop's only blocking point.
Every batch runs on the worker's one stream, one after another.

``Router`` sits in front of ``submit``: a routing target is a concrete
model id (passthrough) or a **split alias** whose weighted arms are
chosen by a hash of the request id, so the same request id lands on the
same arm in every process, and in the JAX package too.

Numerics are untouched: batches are assembled with ``VisionEngine``'s
helpers and run the same compiled plans, so fleet-routed logits are
bitwise a standalone engine's.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.registry import ModelEntry, ModelRegistry
from repro_torch.serving.stats import (
    REQUEST_DEADLINE_SECONDS,
    SLACK_BUCKETS,
    SLO_DEADLINE_SECONDS,
    SLO_VIOLATIONS_TOTAL,
    EngineStats,
    Slo,
)
from repro_torch.serving.vision import (
    Request,
    VisionResult,
    assemble_batch,
    fail_batch,
    resolve_batch,
)


# ---------------------------------------------------------------------------
# Router — deterministic A/B traffic splitting
# ---------------------------------------------------------------------------


def _hash_fraction(request_id: str) -> float:
    """Deterministic uniform fraction in [0, 1) from a request id."""
    digest = hashlib.sha256(str(request_id).encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


def parse_split(spec: str) -> dict[str, float]:
    """CLI split spec ``"a=0.9,b=0.1"`` → {model_id: weight}."""
    arms: dict[str, float] = {}
    for part in spec.split(","):
        mid, _, w = part.partition("=")
        mid = mid.strip()
        if not mid or not w:
            raise ValueError(f"bad split spec {spec!r} (want a=0.9,b=0.1)")
        arms[mid] = float(w)
    return arms


class Router:
    """Maps routing targets to model ids, with weighted A/B split aliases.

    A target that is not a split alias resolves to itself.  Split arms are
    normalised and kept in sorted order; the arm is where the request-id
    hash falls on the cumulative weight line, so the choice is a pure
    function of (splits, request id).
    """

    def __init__(self, splits: dict[str, dict[str, float]] | None = None):
        self._splits: dict[str, tuple[tuple[str, float], ...]] = {}
        for alias, arms in (splits or {}).items():
            self.add_split(alias, arms)

    def add_split(self, alias: str, arms: dict[str, float]) -> None:
        if not arms:
            raise ValueError(f"split {alias!r} has no arms")
        total = float(sum(arms.values()))
        if total <= 0:
            raise ValueError(f"split {alias!r} weights must sum > 0")
        if any(w < 0 for w in arms.values()):
            raise ValueError(f"split {alias!r} has a negative weight")
        self._splits[alias] = tuple(
            (mid, w / total) for mid, w in sorted(arms.items())
        )

    def arms(self, alias: str) -> tuple[tuple[str, float], ...]:
        return self._splits[alias]

    @property
    def aliases(self) -> list[str]:
        return sorted(self._splits)

    def resolve(self, target: str, request_id: str) -> str:
        """Routing target + request id → concrete model id."""
        arms = self._splits.get(target)
        if arms is None:
            return target
        frac = _hash_fraction(request_id)
        acc = 0.0
        for mid, w in arms:
            acc += w
            if frac < acc:
                return mid
        return arms[-1][0]  # frac ~ 1.0 lands on the last arm


# ---------------------------------------------------------------------------
# Page-locked staging of batches bound for the card
# ---------------------------------------------------------------------------


class _PinnedSlots:
    """Two page-locked int32 host buffers per batch shape, used in turn.

    Each slot is ``[host tensor, event]``; the event is recorded behind
    the slot's last host→device copy, and ``take`` waits on it (only if it
    has not completed) before handing the slot out again.  Not locked:
    only the engine's worker (or a caller while it idles) takes slots.
    """

    def __init__(self):
        self._slots: dict[tuple[int, ...], list[list]] = {}
        self._turn: dict[tuple[int, ...], int] = {}

    def take(self, shape: tuple[int, ...]) -> list:
        slots = self._slots.get(shape)
        if slots is None:
            slots = self._slots[shape] = [
                [torch.empty(shape, dtype=torch.int32, pin_memory=True),
                 torch.cuda.Event()]
                for _ in range(2)
            ]
            self._turn[shape] = 0
        turn = self._turn[shape]
        self._turn[shape] = 1 - turn
        slot = slots[turn]
        if not slot[1].query():  # this slot's last copy is still in flight
            slot[1].synchronize()
        return slot


def _on_cuda(plan) -> torch.device | None:
    """The plan's device if it is a CUDA device, else None."""
    dev = torch.device(plan.device)
    return dev if dev.type == "cuda" else None


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------


class FleetEngine:
    """Multi-model continuous-batching engine over a ModelRegistry.

    One daemon worker serves every registered model; per-model queues are
    drained by smooth weighted round-robin and batches are double-
    buffered (assemble N+1 on the host while N runs on the card).

    Observability: ``metrics`` (defaulting to the registry's shared
    ``MetricRegistry``, if it has one) adds the fleet-wide counters as
    ``serve_*_total{model="_fleet"}`` plus a per-model
    ``serve_queue_depth`` gauge and a ``serve_batch_fill`` histogram
    (real fraction of every launched batch).  ``tracer`` (an
    ``obs.Tracer``) records one span per batch-lifecycle phase —
    ``fleet.assemble`` / ``.dispatch`` / ``.fetch`` / ``.deliver`` —
    tagged with the model id.  On a CUDA plan ``fleet.dispatch`` closes
    when the launches are queued and ``fleet.fetch`` holds the wait for
    the card.  Every metric on the dispatch path is a host integer: none
    reads a device tensor.

    SLO attribution: a model whose ``ModelEntry`` carries an
    ``Slo(deadline_ms)`` gets every delivered request's deadline slack
    recorded (``serve_request_deadline_seconds{model=…}`` histogram,
    ``serve_slo_violations_total{model=…}`` counter,
    ``serve_slo_deadline_seconds`` gauge) plus an engine-local roll-up in
    ``slo_snapshot()``.
    """

    def __init__(
        self,
        registry: ModelRegistry,
        *,
        batch_size: int = 32,
        queue_depth: int = 256,
        weights: dict[str, float] | None = None,
        router: Router | None = None,
        coalesce_ms: float = 1.0,
        metrics: MetricRegistry | None = None,
        tracer: Tracer | None = None,
    ):
        self.registry = registry
        self.batch_size = batch_size
        self.queue_depth = queue_depth
        self.coalesce_ms = coalesce_ms
        self.router = router or Router()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # pre-bound batch-lifecycle spans: the name (and, for attr-less
        # phases, the attrs dict) is resolved once here, not per batch
        self._span_assemble = self.tracer.bind("fleet.assemble")
        self._span_dispatch = self.tracer.bind("fleet.dispatch")
        self._span_fetch = self.tracer.bind("fleet.fetch")
        self._span_deliver = self.tracer.bind("fleet.deliver")
        # inherit the registry's shared metrics; an explicit metrics= wins
        self.metrics = metrics if metrics is not None else registry.metrics
        if self.metrics is not None:
            # fleet-wide counters join the per-model families under a
            # reserved label value (a real id can't be empty, "_fleet" is
            # ours by convention)
            self.stats = EngineStats(registry=self.metrics,
                                     labels={"model": "_fleet"})
            self._depth_gauge = self.metrics.gauge(
                "serve_queue_depth", "queued requests per model",
                labels=("model",),
            )
            self._fill_hist = self.metrics.histogram(
                "serve_batch_fill",
                "real (unpadded) fraction of each launched batch",
                buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
            )
            self._deadline_hist = self.metrics.histogram(
                REQUEST_DEADLINE_SECONDS,
                "per-request deadline slack in seconds "
                "(negative = SLO violated)",
                labels=("model",), buckets=SLACK_BUCKETS,
            )
            self._slo_violations = self.metrics.counter(
                SLO_VIOLATIONS_TOTAL,
                "requests answered after their model's SLO deadline",
                labels=("model",),
            )
            self._slo_deadline = self.metrics.gauge(
                SLO_DEADLINE_SECONDS,
                "configured per-model SLO deadline",
                labels=("model",),
            )
        else:
            self.stats = EngineStats()  # fleet-wide; per-model in entry.stats
            self._depth_gauge = None
            self._fill_hist = None
            self._deadline_hist = None
            self._slo_violations = None
            self._slo_deadline = None
        # per-model SLO accounting (requests, violations) — written only
        # by the worker thread, read by slo_snapshot()
        self._slo_counts: dict[str, list[int]] = {}
        self._pinned = _PinnedSlots()
        self._weights = dict(weights or {})
        self._wrr: dict[str, float] = {}
        self._queues: dict[str, deque[Request]] = {}
        self._cond = threading.Condition()
        self._closed = False
        self._auto_id = 0
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    # ---- client API -------------------------------------------------------

    def submit(self, image: np.ndarray, *, model: str,
               request_id: str | None = None) -> "Future[VisionResult]":
        """Enqueue one image for ``model`` (a model id or a split alias).

        Blocks only when the target model's queue is full (backpressure).
        ``request_id`` pins A/B routing; omitted ids get a process-local
        sequence number (unique, but not stable across runs).
        """
        if request_id is None:
            with self._cond:
                request_id = f"auto-{self._auto_id}"
                self._auto_id += 1
        model_id = self.router.resolve(model, request_id)
        entry = self.registry.get(model_id)  # raises on unknown id
        if tuple(image.shape) != entry.input_shape:
            raise ValueError(
                f"image shape {tuple(image.shape)} != model "
                f"{model_id!r} input shape {entry.input_shape}"
            )
        req = Request(np.asarray(image, np.int32), Future(),
                      time.perf_counter())
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is closed")
            while True:
                # re-fetched after every wait: the idle housekeeping may
                # have deleted an evicted model's drained queue meanwhile,
                # and a request appended to that orphan would be stranded
                q = self._queues.setdefault(model_id, deque())
                if len(q) < self.queue_depth:
                    break
                self._cond.wait()
                if self._closed:
                    raise RuntimeError("engine is closed")
            q.append(req)
            if self._depth_gauge is not None:
                self._depth_gauge.labels(model=model_id).set(len(q))
            self._cond.notify_all()
        return req.future

    def classify(self, images, *, model: str) -> list[int]:
        """Blocking convenience: a list of images → predicted labels."""
        futs = [self.submit(img, model=model) for img in images]
        return [f.result().label for f in futs]

    def snapshot(self) -> dict:
        """Fleet-wide + per-model stats in one JSON-ready dict."""
        return {"fleet": self.stats.snapshot(),
                "models": self.registry.snapshot(),
                "slo": self.slo_snapshot()}

    def slo_snapshot(self) -> dict:
        """Per-model SLO attribution: {model: requests/violations/frac}.

        Only models with a configured ``Slo`` appear.  Written solely by
        the worker thread; a concurrent read sees some prefix of the
        delivered batches.
        """
        return {
            mid: {"requests": c[0], "violations": c[1],
                  "violation_frac": c[1] / c[0] if c[0] else 0.0}
            for mid, c in sorted(self._slo_counts.items())
        }

    def close(self):
        """Drain every queue (all futures resolve) and stop the worker."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker -----------------------------------------------------------

    def _pick_model(self, *, commit: bool = True, min_items: int = 1,
                    aged_before: float | None = None) -> str | None:
        """Smooth weighted round-robin over models with queued work.

        Every active model's credit grows by its weight each round and the
        highest-credit model pays the round total when picked: over W
        rounds a weight-w model is picked w/W of the time.

        ``commit=False`` answers which model would be picked without
        advancing credits.  ``min_items`` restricts the round to queues
        holding at least that many requests; ``aged_before`` also admits a
        partial queue whose head request predates that time (the
        anti-starvation valve).  Caller holds ``self._cond``.
        """
        active = [
            mid for mid, q in self._queues.items()
            if len(q) >= min_items
            or (q and aged_before is not None
                and q[0].t_submit < aged_before)
        ]
        if not active:
            return None
        total = 0.0
        best = None
        tentative: dict[str, float] = {}
        for mid in sorted(active):  # sorted: deterministic tie-break
            w = self._weights.get(mid, 1.0)
            tentative[mid] = self._wrr.get(mid, 0.0) + w
            total += w
            if best is None or tentative[mid] > tentative[best]:
                best = mid
        if commit:
            self._wrr.update(tentative)
            self._wrr[best] -= total
        return best

    def _next_batch(self, *, block: bool, aged_before: float | None = None):
        """Pop ≤ batch_size requests from the WRR-chosen model queue.

        ``block=False`` is the double-buffering path: a batch is in flight,
        so only a **full** queue is popped (a partial batch popped now
        would fragment its cohort across several padded launches), or a
        partial one whose head predates the in-flight dispatch
        (``aged_before``: it has sat out a full round).  From idle
        (``block=True``) the worker holds a coalescing window of
        ``coalesce_ms`` for the queue WRR would pop to fill.  Returns
        ``None`` when there is no work (and, if ``block``, the engine is
        closed).
        """
        with self._cond:
            if not block:
                model_id = self._pick_model(min_items=self.batch_size,
                                            aged_before=aged_before)
                return None if model_id is None else self._pop(model_id)
            # idle housekeeping: drop the scheduler state of evicted
            # models whose queues have drained
            for mid in [m for m, q in self._queues.items()
                        if not q and m not in self.registry]:
                del self._queues[mid]
                self._wrr.pop(mid, None)
            while not any(self._queues.values()):
                if self._closed:
                    return None
                self._cond.wait()
            if self.coalesce_ms > 0:
                deadline = time.perf_counter() + self.coalesce_ms / 1e3
                while (not self._closed
                       and len(self._queues[
                           self._pick_model(commit=False)])
                       < self.batch_size):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            return self._pop(self._pick_model())

    def _pop(self, model_id: str):
        """Pop ≤ batch_size requests; caller holds ``self._cond``."""
        q = self._queues[model_id]
        items = [q.popleft() for _ in range(min(len(q), self.batch_size))]
        if self._depth_gauge is not None:
            self._depth_gauge.labels(model=model_id).set(len(q))
        self._cond.notify_all()  # free backpressured submitters
        return model_id, items

    def _assemble(self, model_id: str, items: list[Request]):
        """Stack + pad one popped batch; returns (entry, items, batch, plan)
        or None on failure (futures failed in place).

        For a CUDA plan the batch is stacked straight into a page-locked
        slot (``batch`` is the slot); otherwise it is a numpy array.  The
        guard is broad on purpose: any escape (a model evicted while
        queued, or re-registered with another input shape) would kill the
        engine's only worker thread and hang every pending future.
        """
        with self._span_assemble(model=model_id, n=len(items)):
            try:
                entry: ModelEntry = self.registry.get(model_id)
                plan = entry.plan  # read once: hot-swap flips atomically
                pad = self.registry.pad_buffer(plan.input_shape)
                if _on_cuda(plan) is None:
                    batch = assemble_batch(items, pad, self.batch_size)
                else:
                    batch = self._pinned.take(
                        (self.batch_size, *(int(d) for d in plan.input_shape)))
                    np.stack([r.image for r in items]
                             + [pad] * (self.batch_size - len(items)),
                             out=batch[0].numpy())
            except Exception as e:
                fail_batch(items, RuntimeError(
                    f"cannot assemble batch for model {model_id!r} "
                    f"(evicted, or replaced with an incompatible "
                    f"model?): {e}"))
                return None
        return entry, items, batch, plan

    def _dispatch(self, assembled):
        """Launch one assembled batch without waiting for the card; returns
        in-flight state (entry, items, device logits, t_launch) or None
        on failure."""
        entry, items, batch, plan = assembled
        with self._span_dispatch(model=entry.model_id, n=len(items)):
            t0 = time.perf_counter()
            try:
                device = _on_cuda(plan)
                if device is None:
                    dev = plan.logits(batch)
                else:
                    host, copied = batch
                    x = host.to(device, non_blocking=True)
                    copied.record(torch.cuda.current_stream(device))
                    dev = plan.logits(x)
            except Exception as e:  # a launch refused, a shape the plan rejects
                fail_batch(items, e)
                return None
        return entry, items, dev, t0

    def _fetch(self, inflight):
        """Block until one in-flight batch completes; returns results or
        None on failure (futures failed in place).

        The completion time is stamped HERE: delivery happens after the
        next batch's dispatch, and charging this batch's waiters for that
        dispatch would misattribute it to requests already finished.
        """
        entry, items, dev, t0 = inflight
        with self._span_fetch(model=entry.model_id):
            try:
                logits = dev.cpu().numpy()
            except Exception as e:  # a fault on the card surfaces at the fetch
                fail_batch(items, e)
                return None
        return entry, items, logits, t0, time.perf_counter()

    def _deliver(self, fetched) -> None:
        """Record stats, then resolve one completed batch's futures (stats
        first: a client that unblocks and snapshots sees its batch)."""
        entry, items, logits, t0, t_done = fetched
        n = len(items)
        with self._span_deliver(model=entry.model_id, n=n):
            entry.stats.record_batch(n, self.batch_size - n, t_done - t0)
            self.stats.record_batch(n, self.batch_size - n, t_done - t0)
            if self._fill_hist is not None:
                self._fill_hist.observe(n / self.batch_size)
            if entry.slo is not None:
                self._attribute_slo(entry, items, t_done)
            resolve_batch(items, logits, t_done)

    def _attribute_slo(self, entry: ModelEntry, items: list[Request],
                       t_done: float) -> None:
        """Per-request deadline attribution for one delivered batch, on the
        end-to-end latency (submit → delivery-ready): queueing behind
        other models' batches is a cost the deadline must see."""
        slo: Slo = entry.slo
        deadline_s = slo.deadline_s
        slacks = [deadline_s - (t_done - req.t_submit) for req in items]
        violations = sum(1 for s in slacks if s < 0)
        counts = self._slo_counts.setdefault(entry.model_id, [0, 0])
        counts[0] += len(items)
        counts[1] += violations
        if self.metrics is not None:
            hist = self._deadline_hist.labels(model=entry.model_id)
            # touch the violation counter even when zero: a scrape must
            # distinguish "no misses" from "never attributed"
            violation_ctr = self._slo_violations.labels(
                model=entry.model_id)
            with self.metrics.lock:  # scrape-atomic per batch
                self._slo_deadline.labels(model=entry.model_id).set(
                    deadline_s)
                for s in slacks:
                    hist.observe(s)
                if violations:
                    violation_ctr.inc(violations)

    def _serve_loop(self):
        # Exactly ONE batch executes at any moment, and the host work hides
        # behind it:
        #
        #   assemble N+1   (overlaps N's execution on the card)
        #   fetch N        (the only blocking point)
        #   dispatch N+1   (the card busy again at once)
        #   deliver N      (futures/argmax/stats overlap N+1's execution)
        #
        # On one CUDA stream, dispatching N+1 before fetching N would be
        # safe too (the stream orders the two batches) and would close the
        # gap of one fetch; this order is the JAX package's.
        inflight = None
        while True:
            nxt = self._next_batch(
                block=inflight is None,
                aged_before=inflight[3] if inflight is not None else None)
            if nxt is None and inflight is None:
                return  # closed and fully drained
            assembled = self._assemble(*nxt) if nxt is not None else None
            fetched = self._fetch(inflight) if inflight is not None else None
            inflight = self._dispatch(assembled) if assembled else None
            if fetched is not None:
                self._deliver(fetched)
