"""Lightweight span tracing for train + serve hot paths (port of
``repro.obs.trace``).

A ``Tracer`` records named spans on the monotonic clock
(``time.monotonic_ns`` — immune to wall-clock steps) with thread-local
nesting: a span opened inside another span on the same thread carries
its ``parent_id``, so an exported trace reconstructs the call tree —
e.g. one ``fleet.batch`` span containing ``assemble`` → ``dispatch`` →
``fetch`` → ``deliver`` children, or a ``train.step`` span containing a
``checkpoint`` child.

Design points:

  * **bounded** — spans land in a ``deque(maxlen=capacity)``; a
    long-lived engine never grows host memory per batch.  ``recorded``
    counts everything ever finished, so ``recorded - len(snapshot())``
    is the number of evicted (oldest) spans;
  * **thread-safe** — each thread keeps its own nesting stack
    (``threading.local``), the finished-span buffer is lock-protected;
  * **cheap when off** — ``NULL_TRACER`` is a no-op stand-in with the
    same surface, so instrumented code reads
    ``self.tracer.span("assemble")`` unconditionally;
  * **cheap when on** — a span is a small ``__slots__`` context manager
    (no ``@contextmanager`` generator machinery), ids come from an
    atomic counter instead of a lock round-trip, the per-thread name is
    cached, and attr-less spans share one empty dict.  Hot paths
    pre-bind the span name once (``bound = tracer.bind("fleet.fetch")``,
    then ``with bound(model=...)``) so the per-call cost is one object
    allocation + two clock reads + one lock acquisition at exit —
    what lets the fleet batch loop trace every phase;
  * **profiler bridge** — ``annotate=True`` additionally wraps each span
    in ``torch.profiler.record_function``, making the spans visible as
    named ranges inside a ``torch.profiler`` trace (on the CPU and on the
    card) without a second instrumentation pass.

A span measures the host: on CUDA a span around a launch closes when the
launch is queued, not when the card finishes it.

**The active tracer.**  A process has one active tracer, ``NULL_TRACER``
unless ``use(tracer)`` installs another for the enclosed code.  The
port's layers read it at each span (``active().span(...)``): the step
(``step.*`` in ``core/les.py``, ``parallel/dp.py``), the blocks
(``blocks.*`` in ``core/model.py``, ``core/les.py``), the dispatchers
(``dispatch.<fn>`` in ``kernels/*/ops.py`` and ``core/numerics.py``
``int_matmul``), the CUDA wrappers (``kernel.<entry>``), the plan
(``plan.logits`` / ``plan.layer``) and the exchange (``parallel.*``).
No signature carries a tracer.  With nothing installed a span costs a
global read and the shared no-op context manager: no clock read and no
lock.  ``launch/train.py --trace-out`` installs its tracer this way, so
its JSONL export holds the step's inner spans under ``train.step``.

**On the profiler's clock.**  ``Tracer.anchor()`` reads
``(monotonic_ns, time_ns)`` back to back.  ``torch.profiler``'s Chrome
trace puts a host event at ``ts``·1000 + ``baseTimeNanoseconds`` on the
``time_ns`` clock (``ts`` in µs), so a span at monotonic time t sits on
the trace's clock at (t − mono + real − base) / 1000 µs, for the anchor
(mono, real) read in the same process.  A device operation's host-side
launch record (its ``correlation`` id) then falls inside the span that
launched it: with torch 2.11 and CUDA 12.8 on an H100, each marker
kernel's ``cudaLaunchKernel`` record lay 1.3–3.7 µs after its span
opened and 0.4–2.1 µs before it closed (``perfbench/program_trace.py``
checks this in every traced run), and ``time_ns − monotonic_ns`` moved
under 0.06 µs over a one-second stretch.

``export_jsonl`` writes one span per line (ns integers, start-ordered)
for offline analysis; the JAX package's ``docs/OBSERVABILITY.md`` shows
how to read it.
"""

from __future__ import annotations

import functools
import itertools
import json
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, NamedTuple


class Span(NamedTuple):
    """One finished span (times in ns on the monotonic clock)."""

    name: str
    t_start_ns: int
    t_end_ns: int
    span_id: int
    parent_id: int | None
    thread: str
    attrs: dict[str, Any]

    @property
    def duration_ns(self) -> int:
        return self.t_end_ns - self.t_start_ns


def _trace_annotation_cls():
    """``torch.profiler.record_function``: a context manager per span name.

    Imported here, not at module scope: the tracer without the bridge
    needs nothing of torch.
    """
    from torch.profiler import record_function
    return record_function


# Shared by every attr-less span: allocating a fresh dict per span was a
# measurable slice of the fleet batch loop's tracing overhead.  Treat as
# immutable (Span.attrs aliases it).
_EMPTY_ATTRS: dict[str, Any] = {}


class _ThreadState(threading.local):
    """Per-thread nesting stack + cached thread name.

    ``threading.current_thread().name`` costs a dict lookup and an
    attribute walk per call; spans close often enough that caching it
    per thread is worth the subclassed-local dance.
    """

    def __init__(self):
        self.stack: list[int] = []
        self.name: str = threading.current_thread().name


class _SpanHandle:
    """One in-flight span: a plain ``__slots__`` context manager.

    Replaces the historical ``@contextmanager`` generator — generator
    frames, ``next()`` dispatch and the try/finally trampoline cost
    ~10× this object's allocation on the fleet batch hot path.  The
    span is recorded even when the body raises — a failing batch still
    shows up in the trace, with its true duration.
    """

    __slots__ = ("_tracer", "_name", "_attrs", "_parent", "_span_id",
                 "_t0", "_bridge")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> int:
        tracer = self._tracer
        stack = tracer._state.stack
        self._parent = stack[-1] if stack else None
        self._span_id = span_id = next(tracer._ids)
        stack.append(span_id)
        if tracer._annotation is not None:
            self._bridge = tracer._annotation(self._name)
            self._bridge.__enter__()
        else:
            self._bridge = None
        self._t0 = time.monotonic_ns()
        return span_id

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.monotonic_ns()
        tracer = self._tracer
        state = tracer._state
        state.stack.pop()
        if self._bridge is not None:
            self._bridge.__exit__(exc_type, exc, tb)
        with tracer._lock:
            tracer._spans.append(Span(
                name=self._name, t_start_ns=self._t0, t_end_ns=t1,
                span_id=self._span_id, parent_id=self._parent,
                thread=state.name, attrs=self._attrs,
            ))
            tracer.recorded += 1
        return False


class _BoundSpan:
    """A span factory with the name pre-bound (``tracer.bind(name)``).

    Calling it returns a fresh ``_SpanHandle`` — per-call state cannot
    be shared, nesting and concurrent use of the same name must work —
    but the name lookup, kwargs plumbing, and (for attr-less calls) the
    attrs dict are paid once at bind time instead of per span.
    """

    __slots__ = ("_tracer", "_name")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._name = name

    def __call__(self, **attrs) -> _SpanHandle:
        return _SpanHandle(self._tracer, self._name,
                           attrs if attrs else _EMPTY_ATTRS)


class Tracer:
    """Records nested spans; export with ``snapshot()``/``export_jsonl``."""

    def __init__(self, *, capacity: int = 65536, annotate: bool = False):
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._state = _ThreadState()
        self._ids = itertools.count(1)  # CPython next() is atomic
        self.recorded = 0  # total spans ever finished (incl. evicted)
        self._annotation = _trace_annotation_cls() if annotate else None

    def span(self, name: str, **attrs) -> _SpanHandle:
        """Context manager recording one span around its body."""
        return _SpanHandle(self, name, attrs if attrs else _EMPTY_ATTRS)

    def bind(self, name: str) -> _BoundSpan:
        """Pre-bind ``name``: hot paths call the result as ``bound(**attrs)``."""
        return _BoundSpan(self, name)

    def event(self, name: str, **attrs) -> None:
        """Record an instantaneous (zero-duration) span."""
        with self.span(name, **attrs):
            pass

    @staticmethod
    def anchor() -> tuple[int, int]:
        """``(monotonic_ns, time_ns)`` read back to back, from the tightest
        of a few tries (the monotonic reading at the wall reading's
        midpoint): what carries a span onto a clock that counts
        ``time_ns``, such as a ``torch.profiler`` trace's."""
        best = None
        for _ in range(5):
            m0 = time.monotonic_ns()
            real = time.time_ns()
            m1 = time.monotonic_ns()
            if best is None or m1 - m0 < best[0]:
                best = (m1 - m0, (m0 + m1) // 2, real)
        return best[1], best[2]

    def snapshot(self) -> list[Span]:
        """The retained spans, oldest first (a consistent copy)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def export_jsonl(self, path: str) -> int:
        """Write one JSON line per span, start-ordered; returns the count."""
        spans = sorted(self.snapshot(), key=lambda s: s.t_start_ns)
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps({
                    "name": s.name,
                    "t_start_ns": s.t_start_ns,
                    "t_end_ns": s.t_end_ns,
                    "duration_ns": s.duration_ns,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "thread": s.thread,
                    "attrs": s.attrs,
                }, sort_keys=True) + "\n")
        return len(spans)


class _NullTracer:
    """No-op stand-in: same surface as ``Tracer``, near-zero cost.

    Instrumented hot paths hold a tracer unconditionally
    (``tracer = tracer or NULL_TRACER``) instead of branching at every
    phase.
    """

    recorded = 0

    # one reusable, reentrant no-op CM: nullcontext carries no per-entry
    # state, so sharing a single instance is safe and allocation-free
    _NULL_CM = nullcontext(0)

    def span(self, name: str, **attrs):
        return self._NULL_CM

    def bind(self, name: str):
        return self._null_bound

    @staticmethod
    def _null_bound(**attrs):
        return _NullTracer._NULL_CM

    def event(self, name: str, **attrs) -> None:
        pass

    def snapshot(self) -> list[Span]:
        return []

    def clear(self) -> None:
        pass

    def export_jsonl(self, path: str) -> int:
        with open(path, "w"):
            pass
        return 0


NULL_TRACER = _NullTracer()


_active = NULL_TRACER


def active():
    """The process's active tracer: ``NULL_TRACER`` unless ``use`` has
    installed one."""
    return _active


class use:
    """Context manager: install ``tracer`` as the active tracer for the
    enclosed code, then restore the one before it (also when the body
    raises).  Nests."""

    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer):
        self._tracer = tracer

    def __enter__(self):
        global _active
        self._prev = _active
        _active = self._tracer
        return self._tracer

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _active
        _active = self._prev
        return False


def spanned(name: str):
    """Decorator: every call of the function runs inside span ``name`` of
    the active tracer."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _active.span(name):
                return fn(*args, **kwargs)

        return call

    return wrap
