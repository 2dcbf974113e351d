"""The program's own spans over a profiled stretch: which layer launched
each device operation, and why the card idles.

The port records spans with ``repro_torch.obs.trace.Tracer`` at each of
its layers (``step.*``, ``blocks.*``, ``dispatch.*``, ``kernel.*``,
``plan.*``, ``parallel.*``) once a tracer is installed with
``obs.trace.use``.  This module installs one over a second profiled
stretch of the cell's own step, after the driver's untraced stretch and
host probe, so that every reading of those stays as it was.

Reading a stretch (``read``): every device operation of the profiler's
Chrome trace carries a ``correlation`` id, and so does the host-side
record of the call that launched it (``cuda_runtime``, or
``cuda_driver``), whose ``ts`` is the launch's time on the trace's host
clock.  ``Tracer.anchor()`` carries the spans onto that clock (the
trace's host events lie at ``ts``·1000 + ``baseTimeNanoseconds`` on
``time_ns``).  Each operation goes to the innermost span open on the
launching thread at its launch.  The launching thread's id in the trace
is read off the marker kernels that open the stretch, each launched
inside a span of its own (``bench.mark``), which also checks the clock:
each marker's launch record must fall inside its span.  Where under 99%
of the stretch's operations have a launch record the readings are None.

The drivers hand the per-layer readers no step to run, so ``reading``
builds the cell again from the run's own arguments (``--workload``,
``--seed``), with the drivers' pieces, and runs the second stretch once
(``rebuilt``): on fresh weights from the seed after the warm-up steps, not
on the window's state.  On a program without ``obs.trace.use`` every
reading is None.  ``harness.finish`` has looked for the forbidden modules
before the readers run, so the second stretch looks again, in this
process and in each rank it started, and ends the run with no result
where it finds one.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import sys
import tempfile
import threading
import time
import traceback
from typing import NamedTuple

from perfbench import faults, harness

COVERAGE = 0.99
MARK_SPAN = "bench.mark"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


class PSpan(NamedTuple):
    """A program span on the trace's clock (µs)."""

    name: str
    start: float
    end: float
    span_id: int
    parent_id: int | None
    thread: str


class Op(NamedTuple):
    """A device operation of the stretch, with its launch record's time
    (None: no record) and the index in ``Stretch.spans`` of the innermost
    span open on the launching thread then (None: no span)."""

    name: str
    cat: str
    start: float
    end: float
    launch: float | None
    span: int | None


class Stretch(NamedTuple):
    """A traced stretch: its operations (markers left out), the program's
    spans, its bounds (µs), the share of operations with a launch record,
    the clock check's margins (µs: the least time from a marker span's
    start to its marker's launch, and from that launch's end to the span's
    end), the host probe's spans (ns on the monotonic clock, or None) and
    how far ``time_ns`` moved against ``monotonic_ns`` over the stretch
    (µs, or None)."""

    ops: list
    spans: list
    start: float
    end: float
    coverage: float
    clock: tuple
    probe: list | None = None
    drift: float | None = None


def to_trace_us(t_ns: int, anchor: tuple, base_ns: int) -> float:
    """A monotonic time (ns) on the trace's clock (µs), for the anchor
    ``(monotonic_ns, time_ns)`` and the trace's ``baseTimeNanoseconds``."""
    mono, real = anchor
    return (t_ns - mono + real - base_ns) / 1000.0


def _innermost(spans: list, times: list) -> list:
    """For each time, the index of the innermost span open at it
    (start ≤ t < end), or None; ``spans`` of one thread, properly nested."""
    # at one instant: ends (inner first), then starts (outer first), then
    # launches; a span of no length holds nothing
    live = [(i, s) for i, s in enumerate(spans) if s.end > s.start]
    events = [(s.start, 1, -s.end, i) for i, s in live]
    events += [(s.end, 0, -s.start, i) for i, s in live]
    events += [(t, 2, 0.0, j) for j, t in enumerate(times) if t is not None]
    events.sort()
    out: list = [None] * len(times)
    stack: list = []
    for _, kind, _, i in events:
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            if stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
        else:
            out[i] = stack[-1] if stack else None
    return out


def read(path: str, spans, anchor: tuple, thread: str, probe=None) -> Stretch:
    """Parse a Chrome trace of a stretch opened and closed by marker
    kernels, each launched inside a ``bench.mark`` span, and attribute its
    operations to ``spans`` (``obs.trace.Span``s, ns) recorded on the
    thread named ``thread``."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc["traceEvents"]
    launches: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None and (corr not in launches or e["ts"] < launches[corr][0]):
                launches[corr] = (float(e["ts"]), float(e.get("dur", 0.0)), e.get("tid"))
    raw = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    marks = [e for e in raw if harness.MARK in e["name"]]
    work = [e for e in raw if harness.MARK not in e["name"]]
    if not work:
        raise RuntimeError("the trace holds no device operation of the stretch")
    first, last = float(work[0]["ts"]), float(work[-1]["ts"]) + float(work[-1].get("dur", 0))
    opening = [e for e in marks if float(e["ts"]) + float(e.get("dur", 0)) <= first]
    closing = [e for e in marks if float(e["ts"]) >= last]
    start = float(opening[0]["ts"]) if opening else first
    end = (float(closing[-1]["ts"]) + float(closing[-1].get("dur", 0))) if closing else last

    moved = [PSpan(s.name, to_trace_us(s.t_start_ns, anchor, base),
                   to_trace_us(s.t_end_ns, anchor, base), s.span_id, s.parent_id, s.thread)
             for s in spans if s.thread == thread]
    # the launching thread's id in the trace, and the clock check: each
    # marker's launch record inside its own span
    mark_spans = sorted((s for s in moved if s.name == MARK_SPAN), key=lambda s: s.start)
    mark_launches = sorted(launches[e["args"]["correlation"]] for e in marks
                           if e.get("args", {}).get("correlation") in launches)
    tids = {tid for _, _, tid in mark_launches}
    margins = [(ts - s.start, s.end - (ts + dur))
               for s, (ts, dur, _) in zip(mark_spans, mark_launches)]
    clock = (min(m[0] for m in margins), min(m[1] for m in margins)) if margins else (None, None)

    in_stretch = [e for e in work if float(e["ts"]) + float(e.get("dur", 0)) > start
                  and float(e["ts"]) < end]
    recs = [launches.get(e.get("args", {}).get("correlation")) for e in in_stretch]
    times = [r[0] if r is not None and r[2] in tids else None for r in recs]
    owner = _innermost(moved, times)
    ops = [Op(e["name"], e["cat"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              r[0] if r is not None else None, o)
           for e, r, o in zip(in_stretch, recs, owner)]
    coverage = sum(r is not None for r in recs) / len(recs) if recs else 0.0
    return Stretch(ops, moved, start, end, coverage, clock, probe)


# ---------------------------------------------------------------------------
# What a stretch says
# ---------------------------------------------------------------------------


def chains(st: Stretch) -> list:
    """For each span, the names of it and its ancestors, innermost first."""
    by_id = {s.span_id: i for i, s in enumerate(st.spans)}
    out = []
    for s in st.spans:
        names, p = [s.name], s.parent_id
        while p is not None and p in by_id:
            names.append(st.spans[by_id[p]].name)
            p = st.spans[by_id[p]].parent_id
        out.append(names)
    return out


def _dur(op: Op, st: Stretch) -> float:
    return max(min(op.end, st.end) - max(op.start, st.start), 0.0)


def steps(st: Stretch) -> list:
    """The stretch's ``step.train`` spans, in order."""
    return sorted((s for s in st.spans if s.name == "step.train"), key=lambda s: s.start)


def usable(st: Stretch | None) -> bool:
    return st is not None and st.coverage >= COVERAGE


#: layers whose own metrics read their device time: the blocks' is the rest
#: of the step
OTHER_LAYERS = ("dispatch.", "parallel.")


def step_parts(st: Stretch) -> dict | None:
    """Device ms a step, over steps 2 on, of the operations launched inside
    ``step.train``: in all, and inside ``dispatch.*`` spans, inside
    ``parallel.*`` spans (the exchange) and outside both (the blocks')."""
    st_steps = steps(st)
    if not usable(st) or len(st_steps) < 2:
        return None
    cut, ch = st_steps[1].start, chains(st)
    parts = dict.fromkeys(("step", "dispatch.", "parallel.", "blocks"), 0.0)
    for o in st.ops:
        if o.span is None or o.launch < cut or "step.train" not in ch[o.span]:
            continue
        d = _dur(o, st)
        parts["step"] += d
        owner = next((p for p in OTHER_LAYERS for n in ch[o.span] if n.startswith(p)),
                     "blocks")
        parts[owner] += d
    return {k: v / 1000.0 / (len(st_steps) - 1) for k, v in parts.items()}


def blocks_device_ms(st: Stretch) -> float | None:
    """Device ms a step, over steps 2 on, of the operations launched inside
    ``step.train`` and outside every ``dispatch.*`` and ``parallel.*``
    span."""
    parts = step_parts(st)
    return None if parts is None else parts["blocks"]


def dispatch_host_ms(st: Stretch) -> float | None:
    """Host ms a step inside the outermost ``dispatch.*`` spans of the host
    probe (steps each begun on an empty queue)."""
    if not usable(st) or not st.probe:
        return None
    by_id = {s.span_id: s for s in st.probe}

    def outermost(s) -> bool:
        p = s.parent_id
        while p is not None and p in by_id:
            if by_id[p].name.startswith("dispatch."):
                return False
            p = by_id[p].parent_id
        return True

    n = sum(s.name == "step.train" for s in st.probe)
    total = sum(s.t_end_ns - s.t_start_ns for s in st.probe
                if s.name.startswith("dispatch.") and outermost(s))
    return total / 1e6 / n if n else None


def gaps(st: Stretch, since: float | None = None) -> list:
    """Idle gaps (start, end, µs) between the stretch's first and last
    operations; with ``since``, those that begin at or after it."""
    busy = harness.Trace(st.ops, [], st.start, st.end, 0).busy_intervals()
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])
            if since is None or a[1] >= since]


def busy_ms(st: Stretch) -> float:
    """Device ms of the stretch in which some operation ran."""
    return harness.Trace(st.ops, [], st.start, st.end, 0).busy_s * 1e3


def _ending(st: Stretch, starts: list, t: float):
    """The first operation that starts at or after ``t`` (the end of a
    gap); ``starts``, the operations' starts (``st.ops`` is in order)."""
    i = bisect.bisect_left(starts, t)
    return st.ops[i] if i < len(st.ops) else None


def host_wait_pct(st: Stretch) -> float | None:
    """Share (%) of the stretch from step 2's first operation on in which
    the card sat idle before an operation whose launch record came after
    the gap began: the card waiting on the host."""
    st_steps = steps(st)
    if not usable(st) or len(st_steps) < 2:
        return None
    cut = st_steps[1].start
    later = [o.start for o in st.ops if o.launch is not None and o.launch >= cut]
    if not later:
        return None
    t0, starts = min(later), [o.start for o in st.ops]
    waited = 0.0
    for s, e in gaps(st, t0):
        o = _ending(st, starts, e)
        if o is not None and o.launch is not None and o.launch > s:
            waited += e - s
    return 100.0 * waited / (st.end - t0)


def plan_host_ms(st: Stretch) -> float | None:
    """Host ms a batch inside ``plan.logits`` over the stretch."""
    d = [s.end - s.start for s in st.spans if s.name == "plan.logits"]
    if not usable(st) or not d:
        return None
    return sum(d) / len(d) / 1000.0


READINGS = {"blocks_device_ms": blocks_device_ms, "dispatch_host_ms": dispatch_host_ms,
            "host_wait_pct": host_wait_pct, "plan_host_ms": plan_host_ms}


def span_table(st: Stretch, per: int) -> list:
    """Per span name, a step (or batch) at a time over ``per``: calls, host
    self ms (the span's time less its children's), device ms of the
    operations it launched itself, and of those launched inside it."""
    ch = chains(st)
    kids: dict = {}
    for s in st.spans:
        kids[s.parent_id] = kids.get(s.parent_id, 0.0) + (s.end - s.start)
    rows: dict = {}
    for s in st.spans:
        r = rows.setdefault(s.name, [0, 0.0, 0.0, 0.0])
        r[0] += 1
        r[1] += (s.end - s.start) - kids.get(s.span_id, 0.0)
    for o in st.ops:
        if o.span is None:
            continue
        rows[st.spans[o.span].name][2] += _dur(o, st)
        for n in set(ch[o.span]):
            rows[n][3] += _dur(o, st)
    return sorted(([n, c / per, h / 1000 / per, d / 1000 / per, inc / 1000 / per]
                   for n, (c, h, d, inc) in rows.items()), key=lambda r: -r[4])


def probe_table(probe: list) -> list:
    """Per span name over the host probe, a step at a time: calls and host
    self ms (the span's time less its children's).  On an empty launch
    queue no launch waits for room, so this is the host's own time, where
    the stretch's self times also hold waits on a full queue."""
    n = sum(s.name == "step.train" for s in probe)
    kids: dict = {}
    for s in probe:
        kids[s.parent_id] = kids.get(s.parent_id, 0) + (s.t_end_ns - s.t_start_ns)
    rows: dict = {}
    for s in probe:
        r = rows.setdefault(s.name, [0, 0])
        r[0] += 1
        r[1] += (s.t_end_ns - s.t_start_ns) - kids.get(s.span_id, 0)
    return sorted(([k, c / n, h / 1e6 / n] for k, (c, h) in rows.items()),
                  key=lambda r: -r[2]) if n else []


def op_owners(st: Stretch, per: int, top: int = 10) -> list:
    """The ``top`` device operations by name, each with its device ms a
    step and the span names that launched them (ms a step, largest first)."""
    by: dict = {}
    for o in st.ops:
        owner = st.spans[o.span].name if o.span is not None else (
            "no launch record" if o.launch is None else "no span")
        d = by.setdefault(harness.short_name(o.name, 72), {})
        d[owner] = d.get(owner, 0.0) + _dur(o, st)
    rows = sorted(by.items(), key=lambda kv: -sum(kv[1].values()))[:top]
    return [(n, sum(d.values()) / 1000 / per,
             sorted(((k, v / 1000 / per) for k, v in d.items()), key=lambda kv: -kv[1]))
            for n, d in rows]


def gap_table(st: Stretch, top: int = 10) -> list:
    """The ``top`` longest idle gaps: (µs, the innermost span open on the
    host at the gap's start, the span that launched the operation ending
    it, that launch's lag behind the gap's start in µs)."""
    rows, starts = [], [o.start for o in st.ops]
    for s, e in sorted(gaps(st), key=lambda g: g[0] - g[1])[:top]:
        open_at = [x for x in st.spans if x.start <= s < x.end]
        host = max(open_at, key=lambda x: x.start).name if open_at else "no span"
        o = _ending(st, starts, e)
        by = (st.spans[o.span].name if o is not None and o.span is not None else "no span")
        lag = (o.launch - s) if o is not None and o.launch is not None else None
        rows.append((e - s, host, by, lag))
    return rows


def table_ops(st: Stretch, gemm, prepass) -> tuple[int, int]:
    """(operations, calls) that a roofline reader's GEMM and pre-pass
    tables pick in the stretch, as ``harness.entry_device_s`` groups them
    (one stream: the port launches on one)."""
    n_ops = calls = 0
    pending = 0
    for o in sorted(st.ops, key=lambda o: o.start):
        if o.cat == "kernel" and harness._matches(o.name, gemm):
            n_ops += pending + 1
            calls += 1
            pending = 0
        elif o.cat == "gpu_memset" or (o.cat == "kernel" and harness._matches(o.name, prepass)):
            pending += 1
        else:
            pending = 0
    return n_ops, calls


def span_ops(st: Stretch, name: str) -> tuple[int, int]:
    """(operations, calls) that spans named ``name`` launched."""
    idx = {i for i, s in enumerate(st.spans) if s.name == name}
    return sum(o.span in idx for o in st.ops), len(idx)


ROOFLINES = (("stream_conv_fwd_roofline", "kernel.stream_conv_fwd"),
             ("stream_conv_grad_w_opt_roofline", "kernel.stream_conv_grad_w_opt"),
             ("stream_conv_roofline", "kernel.stream_conv"))


def report(st: Stretch, per: int, out=None) -> None:
    """The ``[spans]``, ``[ops]``, ``[gaps]``, ``[roofline-check]`` and
    ``[clock]`` lines of a stretch, on ``out`` (stderr)."""
    out = out or sys.stderr
    pr = lambda *a: print(*a, file=out)  # noqa: E731
    pr(f"[spans] {len(st.ops)} device operations, {len(st.spans)} spans, launch records "
       f"for {100 * st.coverage:.2f}%; a step (batch) over {per}")
    if not usable(st):
        pr(f"[spans] under {100 * COVERAGE:.0f}% of operations have a launch record: "
           "no reading")
        return
    for n, calls, host, dev, inc in span_table(st, per):
        pr(f"[spans] {n} calls {calls:.2f} host_self_ms {host:.4f} device_self_ms {dev:.4f} "
           f"device_ms {inc:.4f}")
    parts = step_parts(st)
    if parts is not None:
        pr(f"[spans] step.train device_ms {parts['step']:.4f} = blocks (outside dispatch.* "
           f"and parallel.*) {parts['blocks']:.4f} + inside dispatch.* "
           f"{parts['dispatch.']:.4f} + inside parallel.* {parts['parallel.']:.4f} "
           f"(steps 2-{len(steps(st))})")
    if st.probe:
        for n, calls, host in probe_table(st.probe):
            pr(f"[probe] {n} calls {calls:.2f} host_self_ms {host:.4f}")
        pr(f"[probe] outermost dispatch.* host ms a step {dispatch_host_ms(st):.4f}")
    for n, ms, owners in op_owners(st, per):
        pr(f"[ops] {n} {ms:.4f} ms: " + ", ".join(f"{k} {v:.4f}" for k, v in owners[:6]))
    for us, host, by, lag in gap_table(st):
        lag_s = "none" if lag is None else f"{lag:.2f}"
        pr(f"[gaps] {us:.2f} us host_in {host} ended_by {by} launch_lag_us {lag_s}")
    for metric, span in ROOFLINES:
        rd = harness.metric_reader(metric)
        t_ops, t_calls = table_ops(st, rd.GEMM, rd.PREPASS)
        s_ops, s_calls = span_ops(st, span)
        if t_calls or s_calls:
            pr(f"[roofline-check] {metric}: the reader's tables pick {t_ops} ops in {t_calls} "
               f"calls, {span} launched {s_ops} ops in {s_calls} calls")
    pr(f"[clock] marker launches inside their spans, least margins after the start "
       f"{st.clock[0]} us, before the end {st.clock[1]} us; time_ns less monotonic_ns "
       f"moved {st.drift} us over the stretch")


# ---------------------------------------------------------------------------
# Running the stretch
# ---------------------------------------------------------------------------


class _TracerSpans:
    """``harness.Spans``' surface over the active tracer: the drivers'
    own spans (``batch``, ``train_step``) recorded as ``bench.<name>``."""

    def span(self, name: str):
        from repro_torch.obs import trace

        return trace.active().span("bench." + name)


def _mark(tracer, n: int = 2) -> None:
    import torch

    for _ in range(n):
        with tracer.span(MARK_SPAN):
            torch.cuda._sleep(harness._MARK_CYCLES)


def traced_stretch(run, tracer, device) -> Stretch:
    """Profile ``run()`` (the card's activity alone, as the first stretch)
    between marker kernels, with ``tracer`` installed; read the trace."""
    import torch

    from repro_torch.obs import trace

    torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_program_trace_")
    os.close(fd)
    try:
        anchor = tracer.anchor()
        with trace.use(tracer):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                _mark(tracer)
                run()
                _mark(tracer)
                torch.cuda.synchronize(device)
        after = tracer.anchor()
        prof.export_chrome_trace(path)
        st = read(path, tracer.snapshot(), anchor, threading.current_thread().name)
    finally:
        os.unlink(path)
    return st._replace(drift=((after[1] - after[0]) - (anchor[1] - anchor[0])) / 1000.0)


def measure_train(ctx, step, state) -> Stretch | None:
    """The traced stretch of the traffic's ``profile_steps`` on ``state``,
    then the traced host probe of its ``host_probe_steps``, each begun on
    an empty queue, whose spans the ``Stretch`` carries; None off a card
    (the stretch is a profile of the card)."""
    import torch

    from repro_torch.obs import trace
    from repro_torch.obs.trace import Tracer

    if ctx.device.type != "cuda":
        return None
    tr, dev = ctx.traffic, ctx.device
    box = {"state": state}

    def run():
        for _ in range(tr["profile_steps"]):
            box["state"], _, _ = step(box["state"])

    st = traced_stretch(run, Tracer(), dev)
    probe = Tracer()
    with trace.use(probe):
        for _ in range(tr["host_probe_steps"]):
            torch.cuda.synchronize(dev)
            box["state"], _, _ = step(box["state"])
    torch.cuda.synchronize(dev)
    return st._replace(probe=probe.snapshot())


def measure_infer(ctx) -> Stretch | None:
    """The serving cell's batches through the plan, as its driver issues
    them (the copy in, ``ExecutionPlan.logits``, the labels back one batch
    behind), traced over the traffic's ``profile_batches`` after its
    warm-up batches; None off a card."""
    import torch

    from perfbench.drivers import infer
    from repro_torch.infer.export import freeze
    from repro_torch.infer.plan import compile_plan
    from repro_torch.obs import trace
    from repro_torch.obs.trace import Tracer

    if ctx.device.type != "cuda":
        return None
    tr, dev = ctx.traffic, ctx.device
    batch, n = tr["batch"], tr["dataset_images"]
    cfg = harness.program_config(ctx.config, batch, ctx.scale)
    params, host = infer.inputs(ctx)
    plan = compile_plan(freeze(params, cfg), device=dev)
    bufs = [torch.empty(batch, dtype=torch.int32, pin_memory=True) for _ in range(2)]
    count = [0]

    def classify():
        t = trace.active()
        s = (count[0] * batch) % n
        with t.span("bench.batch"):
            x = host[s:s + batch].to(dev, non_blocking=True)
        logits = plan.logits(x)
        with t.span("bench.readback"):
            buf = bufs[count[0] % 2]
            buf.copy_(logits.argmax(dim=-1).to(torch.int32), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        count[0] += 1
        return ev

    def run(k=tr["profile_batches"]):
        prev = None
        for _ in range(k):
            cur = classify()
            if prev is not None:
                with trace.active().span("bench.readback"):
                    prev.synchronize()
            prev = cur
        prev.synchronize()

    run(tr["warmup_batches"])
    return traced_stretch(run, Tracer(), dev)


def _train_step(ctx, call):
    """The driver's step (``drivers/train.py`` ``make_step``: shuffled
    batches of the traffic's global batch, then ``call``) on a fresh state
    from the seed, warmed up."""
    from perfbench.drivers import train

    tr = ctx.traffic
    cfg = harness.program_config(ctx.config, tr["batch"], ctx.scale)
    params, data, labels, feed = train.inputs(ctx, tr["batch"])
    state = train.new_state(cfg, params, ctx.device)
    step = train.make_step(ctx, call(cfg), data, labels, feed, _TracerSpans())
    for _ in range(tr["warmup_steps"]):
        state, _, _ = step(state)
    return step, state


def measure_one_card(ctx) -> Stretch | None:
    from repro_torch.core import les

    fuse_opt = ctx.traffic["fuse_opt"]
    step, state = _train_step(ctx, lambda cfg: lambda st, x, y, key: les.train_step(
        st, cfg, x, y, key, fuse_opt=fuse_opt))
    return measure_train(ctx, step, state)


def _dp_rank(axis, device, ctx, fault):
    """One rank of the data-parallel cell's second stretch: every rank runs
    the steps, rank 0's stretch is kept; each reports the forbidden modules
    it holds afterwards."""
    from repro_torch.parallel import dp

    with faults.planted(fault):
        ctx, tr = ctx._replace(device=device), ctx.traffic
        step, state = _train_step(ctx, lambda cfg: dp.make_dp_train_step(
            cfg, axis, dp_reduce=tr["reducer"], fuse_opt=tr["fuse_opt"]))
        st = measure_train(ctx, step, state)
        return {"stretch": st if axis.rank == 0 else None,
                "loaded": harness.forbidden_loaded()}


def measure_dp(ctx, fault: str | None = None) -> tuple:
    """Rank 0's stretch and the forbidden modules that any rank held."""
    from repro_torch.parallel import dp

    outs = dp.spawn(_dp_rank, ctx.ranks, device=ctx.device.type, args=(ctx, fault))
    return outs[0]["stretch"], sorted({m for o in outs for m in o["loaded"]})


def second_stretch(ctx, fault: str | None = None) -> Stretch | None:
    """The cell's second stretch (None off a card, or on a failure, whose
    traceback goes to stderr).  ``fault``: one of ``faults.NAMES``, planted
    in this process or, under data parallelism, in every rank (the CPU
    tests).  Where this process or a rank holds a forbidden module
    afterwards, it names it on stderr and ends the run with exit code 3
    before any result is printed."""
    kind = ctx.traffic["kind"]
    st, loaded = None, []
    with faults.planted(None if kind == "dp_train" else fault):
        try:
            if kind == "dp_train":
                st, loaded = measure_dp(ctx, fault)
            elif kind == "infer":
                st = measure_infer(ctx)
            else:
                st = measure_one_card(ctx)
        except Exception:  # a reading that fails leaves the run's result whole
            traceback.print_exc(file=sys.stderr)
        found = sorted(set(harness.forbidden_loaded()) | set(loaded))
    if found:
        print(f"perfbench: loaded {found} in the second stretch, which the benchmark "
              "must not load", file=sys.stderr)
        raise SystemExit(3)
    return st


def cost_line(st: Stretch, first, host_step_s, per: int) -> str:
    """The traced stretch against the driver's first (``first``, a
    ``harness.Trace`` of as many steps or batches): device window and busy
    ms a step, and, for training, the host ms of a step call on an empty
    queue (the first probe's ``train_step`` against the traced probe's
    ``step.train``)."""
    line = (f"[cost] a step (batch), device window ms / busy ms: first stretch "
            f"{first.window_s * 1e3 / per:.4f} / {first.busy_s * 1e3 / per:.4f}, traced "
            f"{(st.end - st.start) / 1000 / per:.4f} / {busy_ms(st) / per:.4f}")
    host = [s.t_end_ns - s.t_start_ns for s in st.probe or () if s.name == "step.train"]
    if host and host_step_s is not None:
        line += (f"; host ms on an empty queue: first probe {host_step_s * 1e3:.4f}, traced "
                 f"probe {sum(host) / len(host) / 1e6:.4f}")
    return line


_cache: dict = {}


def _arguments():
    """This run's ``--workload`` and ``--seed`` (``run.py``'s), or None."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False, exit_on_error=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=0.0)
    try:
        args, _ = ap.parse_known_args(sys.argv[1:])
    except (argparse.ArgumentError, SystemExit):
        return None
    return args if args.workload and args.seed is not None else None


def supported() -> bool:
    """Whether the program records spans into an installed tracer."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return False
    return hasattr(trace, "use") and hasattr(trace, "active")


def rebuilt(r: dict, first) -> Stretch | None:
    """The second stretch of this run's cell, run once, with its lines on
    stderr (None: not a run of the benchmark on a card, or a program
    without the spans).  ``r``, ``first``: the driver's readings and first
    stretch, for the ``[cost]`` line."""
    kind = r["kind"]
    if kind in _cache:
        return _cache[kind]
    _cache[kind] = None
    args = _arguments()
    try:
        import torch
    except ImportError:
        return None
    if args is None or not torch.cuda.is_available() or not supported():
        return None
    from perfbench import context

    t0 = time.perf_counter()
    ctx = context.Context.for_cell(harness.resolve(args.workload), seed=args.seed,
                                   seconds=args.seconds, trace=True,
                                   device=torch.device("cuda", 0), t_start=t0)
    st = second_stretch(ctx)
    if st is not None:
        per = ctx.traffic["profile_batches" if kind == "infer" else "profile_steps"]
        report(st, per)
        if first is not None:
            print(cost_line(st, first, r.get("host_step_s"), per), file=sys.stderr)
        print(f"[spans] second stretch {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    _cache[kind] = st
    return st


def reading(r: dict, name: str, first):
    """Reading ``name`` of ``READINGS`` from this run's second stretch."""
    st = rebuilt(r, first)
    if st is None:
        return None
    v = READINGS[name](st)
    return None if v is None or not math.isfinite(v) else v
