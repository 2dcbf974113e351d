"""PyTorch port, the observability spine: metrics registry, tracer, the
metric-backed serving stats and the CLIs' scrape and trace surfaces.

The counterparts of ``tests/test_obs.py``'s host-side classes, run on the
port (``repro_torch.obs``, the plain PyTorch path on the CPU), plus the
cross-package checks:

  * the same counter / gauge / histogram operations give the same
    ``prometheus_text()`` and ``json_snapshot()`` in both packages;
  * the port's ``ModelRegistry`` + ``FleetEngine`` with ``metrics=`` count
    the same serving samples as JAX's for the same requests;
  * both tracers export the same JSONL keys.

Servers bind port 0 and close in ``with`` / ``finally``; every HTTP read
and ``Future.result`` has a timeout.
"""

import json
import math
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.core import les as jles
from repro.core.blocks import BlockSpec as JBlockSpec
from repro.core.model import NitroConfig as JNitroConfig
from repro.infer import freeze as j_freeze
from repro.obs import metrics as jmetrics
from repro.obs.trace import Tracer as JTracer
from repro.serving import FleetEngine as JFleetEngine
from repro.serving import ModelRegistry as JModelRegistry
from repro_torch.core import les as tles
from repro_torch.core import prng
from repro_torch.core.blocks import BlockSpec
from repro_torch.core.model import NitroConfig
from repro_torch.infer import compile_plan, freeze
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.metrics import (
    REPRO_VERSION,
    MetricError,
    MetricRegistry,
    latency_summary_ms,
    percentile,
    register_build_info,
    start_metrics_server,
)
from repro_torch.obs import trace as otrace
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving import FleetEngine, ModelRegistry, VisionEngine
from repro_torch.serving.stats import EngineStats, fleet_snapshot_delta, snapshot_delta

T = 30  # seconds: every wait in this file is bounded


def tiny_cfg(cls_cfg=NitroConfig, cls_spec=BlockSpec):
    return cls_cfg(
        blocks=(cls_spec("conv", 8, pool=True, d_lr=64), cls_spec("linear", 16)),
        input_shape=(8, 8, 3), num_classes=10, gamma_inv=512, name="tiny-obs",
    )


def _frozen(seed=0):
    cfg = tiny_cfg()
    return freeze(tles.create_train_state(prng.PRNGKey(seed), cfg, device="cpu"), cfg)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-127, 128, (8, 8, 3)).astype(np.int32) for _ in range(n)]


def _get(url):
    with urllib.request.urlopen(url, timeout=T) as resp:
        return resp.status, resp.read()


# ---------------------------------------------------------------------------
# percentile helpers
# ---------------------------------------------------------------------------


class TestPercentileEdges:
    def test_empty_and_single(self):
        assert percentile([], 0.5) == 0.0
        assert percentile([], 1.0) == 0.0
        for q in (0.0, 0.5, 0.99, 1.0):
            assert percentile([42.0], q) == 42.0

    def test_exact_rank_boundaries(self):
        vals = [1.0, 2.0, 3.0, 4.0]
        assert percentile(vals, 0.25) == 1.0
        assert percentile(vals, 0.5) == 2.0
        assert percentile(vals, 0.75) == 3.0
        assert percentile(vals, 1.0) == 4.0
        assert percentile(vals, 0.51) == 3.0

    def test_nearest_rank_invariant_and_jax(self):
        rng = np.random.default_rng(0)
        for n in (1, 2, 3, 5, 10, 100):
            vals = sorted(rng.uniform(0, 1, n).tolist())
            for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
                rank = min(max(math.ceil(q * n), 1), n)
                assert percentile(vals, q) == vals[rank - 1]
                assert percentile(vals, q) == jmetrics.percentile(vals, q)

    def test_latency_summary_edge_cases(self):
        assert latency_summary_ms([]) == {"p50": 0.0, "p90": 0.0, "p95": 0.0, "p99": 0.0}
        assert all(v == pytest.approx(5.0) for v in latency_summary_ms([0.005]).values())
        out = latency_summary_ms([0.002, 0.001])  # unsorted input
        assert out["p50"] == pytest.approx(1.0) and out["p99"] == pytest.approx(2.0)

    def test_serving_stats_reexport_the_obs_helpers(self):
        from repro_torch.serving import stats
        assert stats.percentile is percentile
        assert stats.latency_summary_ms is latency_summary_ms

    def test_snapshot_delta_identity_and_zero(self):
        stats = EngineStats()
        pre = stats.snapshot()
        assert snapshot_delta(pre, pre) == {"requests": 0, "batches": 0,
                                            "padded_slots": 0, "avg_batch_fill": 0.0}
        stats.record_batch(3, 1, 0.01)
        d = snapshot_delta(pre, stats.snapshot())
        assert d["requests"] == 3 and d["batches"] == 1
        assert d["avg_batch_fill"] == pytest.approx(0.75)

    def test_fleet_snapshot_delta_new_model(self):
        empty = {"requests": 0, "batches": 0, "padded_slots": 0, "avg_batch_fill": 0.0}
        pre = {"fleet": empty, "models": {}}
        post = {"fleet": {**empty, "requests": 2, "batches": 1},
                "models": {"late": {**empty, "requests": 2, "batches": 1}}}
        assert fleet_snapshot_delta(pre, post)["models"]["late"]["requests"] == 2


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class TestMetricRegistry:
    def test_counter_gauge_histogram_basics(self):
        reg = MetricRegistry()
        c = reg.counter("x_total", "a counter")
        c.inc()
        c.inc(4)
        assert c.value == 5
        with pytest.raises(MetricError):
            c.inc(-1)
        g = reg.gauge("depth")
        g.set(7)
        g.inc(2)
        g.dec()
        assert g.value == 8
        h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 2.0):
            h.observe(v)
        child = h.labels()
        assert child.count == 3 and child.sum == pytest.approx(2.55)
        assert child.cumulative_buckets() == [(0.1, 1), (1.0, 2), (float("inf"), 3)]
        assert child.percentiles()["p50"] == 0.5
        assert "x_total" in reg and "nope" not in reg

    def test_labels_and_conflicts(self):
        reg = MetricRegistry()
        fam = reg.counter("req_total", "by model", labels=("model",))
        fam.labels(model="a").inc(2)
        fam.labels(model="b").inc()
        assert fam.labels(model="a").value == 2
        with pytest.raises(MetricError):
            fam.labels(wrong="a")
        with pytest.raises(MetricError):
            fam.inc()  # label-less proxy on a labelled family
        assert reg.counter("req_total", labels=("model",)) is fam
        for bad in (lambda: reg.gauge("req_total"),
                    lambda: reg.counter("req_total", labels=("other",)),
                    lambda: reg.counter("bad name!"),
                    lambda: reg.histogram("empty_buckets", buckets=())):
            with pytest.raises(MetricError):
                bad()
        reg.histogram("h", buckets=(1.0,), window=8)
        with pytest.raises(MetricError):
            reg.histogram("h", buckets=(2.0,), window=8)

    def test_histogram_window_is_bounded(self):
        h = MetricRegistry().histogram("w_seconds", buckets=(1.0,), window=4).labels()
        for i in range(10):
            h.observe(float(i))
        assert list(h.window) == [6.0, 7.0, 8.0, 9.0]
        assert h.count == 10  # the cumulative count is not windowed

    def test_prometheus_text_format(self):
        reg = MetricRegistry()
        reg.counter("req_total", "requests", labels=("model",)) \
            .labels(model='a"b\\c\nd').inc(3)
        reg.histogram("lat_seconds", "latency", buckets=(0.5,)).observe(0.1)
        text = reg.prometheus_text()
        for line in ("# HELP req_total requests", "# TYPE req_total counter",
                     r'req_total{model="a\"b\\c\nd"} 3', "# TYPE lat_seconds histogram",
                     'lat_seconds_bucket{le="0.5"} 1', 'lat_seconds_bucket{le="+Inf"} 1',
                     "lat_seconds_sum 0.1", "lat_seconds_count 1"):
            assert line in text
        assert text.endswith("\n")

    def test_jsonl_round_trip(self, tmp_path):
        reg = MetricRegistry()
        reg.counter("a_total", "help a", labels=("m",)).labels(m="x").inc(2)
        reg.gauge("b").set(-3)
        reg.histogram("c_seconds", buckets=(1.0,)).observe(0.5)
        path = str(tmp_path / "metrics.jsonl")
        reg.write_jsonl(path)
        with open(path) as f:
            parsed = MetricRegistry.parse_jsonl(f.read())
        assert parsed == reg.json_snapshot()
        assert parsed["a_total"]["samples"][0] == {"labels": {"m": "x"}, "value": 2}

    def test_thread_safety_under_concurrent_writers(self):
        reg = MetricRegistry()
        c = reg.counter("n_total")
        h = reg.histogram("h_seconds", buckets=(0.5,), window=100_000)
        n_threads, n_iters = 8, 500

        def writer():
            for _ in range(n_iters):
                c.inc()
                h.observe(0.25)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=writer) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for _ in range(20):  # concurrent readers see a parseable exposition
                assert "n_total" in reg.prometheus_text()
                reg.json_snapshot()
            for t in threads:
                t.join(T)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert c.value == n_threads * n_iters
        assert h.labels().count == n_threads * n_iters

    @staticmethod
    def _drive(mod):
        """One sequence of operations on a fresh registry of ``mod``."""
        reg = mod.MetricRegistry()
        mod.register_build_info(reg, backend="cpu")
        req = reg.counter("serve_requests_total", "requests", labels=("model",))
        req.labels(model="a").inc(3)
        req.labels(model="b").inc()
        g = reg.gauge("serve_queue_depth", "depth", labels=("model",))
        g.labels(model="a").set(7)
        g.labels(model="a").dec(2)
        h = reg.histogram("lat_seconds", "latency", buckets=(0.001, 0.01, 0.1), window=4)
        for v in (0.0005, 0.002, 0.02, 0.2, 0.05):
            h.observe(v)
        reg.histogram("slack_seconds", labels=("model",),
                      buckets=(-0.1, 0.0, 0.1)).labels(model="a").observe(-0.05)
        return reg

    @staticmethod
    def _mask(text):
        return "\n".join(ln for ln in text.splitlines()
                         if "process_start_time_seconds" not in ln)

    def test_same_operations_same_exposition_as_jax(self):
        t, j = self._drive(tmetrics), self._drive(jmetrics)
        assert self._mask(t.prometheus_text()) == self._mask(j.prometheus_text())
        ts, js = t.json_snapshot(), j.json_snapshot()
        for snap in (ts, js):
            snap.pop("process_start_time_seconds")
        assert ts == js
        assert json.dumps(ts, sort_keys=True) == json.dumps(js, sort_keys=True)
        assert REPRO_VERSION == jmetrics.REPRO_VERSION


class TestEngineStatsShared:
    def test_labels_require_registry(self):
        with pytest.raises(ValueError):
            EngineStats(labels={"model": "a"})

    def test_shared_registry_children(self):
        reg = MetricRegistry()
        a = EngineStats(registry=reg, labels={"model": "a"})
        b = EngineStats(registry=reg, labels={"model": "b"})
        a.record_batch(3, 1, 0.010)
        b.record_batch(2, 2, 0.020)
        assert a.requests == 3 and b.requests == 2
        assert a.avg_batch_fill == pytest.approx(0.75)
        assert list(a.batch_latency_s) == [0.010]
        text = reg.prometheus_text()
        assert 'serve_requests_total{model="a"} 3' in text
        assert 'serve_requests_total{model="b"} 2' in text
        snap = a.snapshot()
        assert snap["batches"] == 1
        assert snap["batch_latency_ms"]["p50"] == pytest.approx(10.0)

    def test_record_batch_is_atomic_under_the_registry_lock(self):
        """A reader holding the registry lock never sees half a batch."""
        reg = MetricRegistry()
        stats = EngineStats(registry=reg, labels={"model": "a"})
        done = threading.Event()

        def writer():
            for _ in range(2000):
                stats.record_batch(3, 1, 0.001)
            done.set()

        t = threading.Thread(target=writer)
        t.start()
        while not done.is_set():
            snap = stats.snapshot()
            assert snap["requests"] == 3 * snap["batches"] == 3 * snap["padded_slots"]
        t.join(T)
        assert not t.is_alive() and stats.batches == 2000


class TestMetricsServer:
    def test_http_exposition(self):
        reg = MetricRegistry()
        reg.counter("hits_total").inc(5)
        with start_metrics_server(reg, port=0) as server:
            assert server.port != 0
            assert "hits_total 5" in _get(server.url)[1].decode()
            js = json.loads(_get(server.url + ".json")[1])
            assert js["hits_total"]["samples"][0]["value"] == 5
            with pytest.raises(urllib.error.HTTPError):
                _get(f"http://{server.host}:{server.port}/nope")

    def test_scrape_sees_live_updates(self):
        reg = MetricRegistry()
        c = reg.counter("live_total")
        with start_metrics_server(reg) as server:
            for want in (1, 2):
                c.inc()
                assert f"live_total {want}" in _get(server.url)[1].decode()


class TestBuildInfoAndHealthz:
    def test_register_build_info_is_idempotent(self):
        reg = MetricRegistry()
        register_build_info(reg, backend="cpu")
        register_build_info(reg, backend="cpu")
        info = reg.gauge("repro_build_info", labels=("version", "backend"))
        assert info.labels(version=REPRO_VERSION, backend="cpu").value == 1
        assert 0 < reg.gauge("process_start_time_seconds").value <= time.time()
        assert f'repro_build_info{{version="{REPRO_VERSION}",backend="cpu"}} 1' \
            in reg.prometheus_text()

    def test_healthz_endpoint(self):
        with start_metrics_server(MetricRegistry()) as server:
            base = f"http://{server.host}:{server.port}"
            assert _get(f"{base}/healthz") == (200, b"ok\n")
            assert _get(f"{base}/metrics.json")[0] == 200


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class TestTracer:
    def test_nesting_and_monotonic_clock(self):
        tr = Tracer()
        with tr.span("outer", phase="a") as outer_id:
            with tr.span("inner") as inner_id:
                pass
        spans = {s.name: s for s in tr.snapshot()}
        assert spans["inner"].parent_id == outer_id
        assert spans["outer"].parent_id is None
        assert spans["inner"].span_id == inner_id
        assert spans["outer"].attrs == {"phase": "a"}
        assert spans["outer"].t_start_ns <= spans["inner"].t_start_ns
        assert spans["inner"].t_end_ns <= spans["outer"].t_end_ns
        assert tr.recorded == 2

    def test_span_recorded_on_exception(self):
        tr = Tracer()
        with pytest.raises(RuntimeError):
            with tr.span("failing"):
                raise RuntimeError("boom")
        assert [s.name for s in tr.snapshot()] == ["failing"]
        with tr.span("after"):
            pass
        assert tr.snapshot()[-1].parent_id is None

    def test_threads_get_independent_stacks(self):
        tr = Tracer()
        done = threading.Event()

        def worker():
            with tr.span("worker-span"):
                done.wait(T)

        t = threading.Thread(target=worker, name="obs-worker")
        t.start()
        with tr.span("main-span"):
            pass
        done.set()
        t.join(T)
        assert not t.is_alive()
        spans = {s.name: s for s in tr.snapshot()}
        assert spans["main-span"].parent_id is None
        assert spans["worker-span"].parent_id is None
        assert spans["worker-span"].thread == "obs-worker"

    def test_capacity_and_event_and_clear(self):
        tr = Tracer(capacity=3)
        for i in range(5):
            tr.event("e", i=i)
        spans = tr.snapshot()
        assert len(spans) == 3 and tr.recorded == 5
        assert [s.attrs["i"] for s in spans] == [2, 3, 4]
        tr.clear()
        assert tr.snapshot() == [] and tr.recorded == 5

    def test_export_jsonl_round_trip_and_jax_keys(self, tmp_path):
        rows = {}
        for name, tr in (("torch", Tracer()), ("jax", JTracer())):
            with tr.span("a"):
                with tr.span("b", n=3):
                    pass
            path = str(tmp_path / f"{name}.jsonl")
            assert tr.export_jsonl(path) == 2
            with open(path) as f:
                rows[name] = [json.loads(ln) for ln in f]
        t = rows["torch"]
        assert [r["name"] for r in t] == ["a", "b"]
        assert t[1]["parent_id"] == t[0]["span_id"] and t[1]["attrs"] == {"n": 3}
        assert t[0]["duration_ns"] == t[0]["t_end_ns"] - t[0]["t_start_ns"]
        for a, b in zip(t, rows["jax"], strict=True):
            assert sorted(a) == sorted(b)
            assert (a["name"], a["attrs"]) == (b["name"], b["attrs"])

    def test_profiler_bridge(self):
        """``annotate=True`` wraps each span in ``record_function``: the
        span shows as a named range in a ``torch.profiler`` trace."""
        from torch.profiler import ProfilerActivity, profile

        tr = Tracer(annotate=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tr.span("annotated"):
                pass
        assert tr.snapshot()[0].name == "annotated"
        assert "annotated" in {e.key for e in prof.key_averages()}

    def test_null_tracer_surface(self, tmp_path):
        with NULL_TRACER.span("x", a=1) as sid:
            assert sid == 0
        NULL_TRACER.event("y")
        assert NULL_TRACER.snapshot() == []
        NULL_TRACER.clear()
        path = str(tmp_path / "empty.jsonl")
        assert NULL_TRACER.export_jsonl(path) == 0
        with open(path) as f:
            assert f.read() == ""
        assert NULL_TRACER.recorded == 0



def _tensor_leaves(tree):
    """Every tensor of a nested tuple / list / dict, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _tree(spans):
    """(name, parent's name) of every span, and the spans by name."""
    by_id = {s.span_id: s for s in spans}
    edges = [(s.name, by_id[s.parent_id].name if s.parent_id in by_id else None)
             for s in spans]
    named: dict = {}
    for s in spans:
        named.setdefault(s.name, []).append(s)
    return edges, named


class TestActiveTracer:
    def test_use_installs_restores_and_nests(self):
        assert otrace.active() is NULL_TRACER
        outer, inner = Tracer(), Tracer()
        with otrace.use(outer) as got:
            assert got is outer and otrace.active() is outer
            with otrace.use(inner):
                assert otrace.active() is inner
            assert otrace.active() is outer
            with pytest.raises(RuntimeError):
                with otrace.use(inner):
                    raise RuntimeError("boom")
            assert otrace.active() is outer
        assert otrace.active() is NULL_TRACER

    def test_null_span_is_the_shared_no_op(self):
        assert otrace.active().span("step.train", fuse_opt=True) is NULL_TRACER.span("x")

    def test_spanned_reads_the_active_tracer_at_each_call(self):
        @otrace.spanned("dispatch.f")
        def f(x, *, y):
            return x + y

        tr = Tracer()
        assert f(1, y=2) == 3 and tr.snapshot() == []
        with otrace.use(tr):
            assert f(2, y=3) == 5
        assert [s.name for s in tr.snapshot()] == ["dispatch.f"]

    def test_anchor_maps_a_span_onto_the_profiler_clock(self, tmp_path):
        """A ``record_function`` range opened inside a span falls inside
        the span once the anchor carries it onto the trace's clock
        (``ts``·1000 + ``baseTimeNanoseconds`` on ``time_ns``)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        tr = Tracer()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tr.span("outer"):
                time.sleep(0.002)
                with record_function("inner"):
                    time.sleep(0.002)
                time.sleep(0.002)
        mono, real = tr.anchor()
        assert abs((time.time_ns() - real) - (time.monotonic_ns() - mono)) < 10 ** 6
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        base = int(doc.get("baseTimeNanoseconds", 0))
        inner = next(e for e in doc["traceEvents"] if e.get("name") == "inner"
                     and e.get("ph") == "X")
        span = tr.snapshot()[0]
        start = (span.t_start_ns - mono + real - base) / 1000
        end = (span.t_end_ns - mono + real - base) / 1000
        assert start < float(inner["ts"]) < float(inner["ts"]) + float(inner["dur"]) < end

    @pytest.mark.parametrize("fuse_opt", [True, False])
    def test_train_step_records_the_layer_tree_and_changes_no_bit(self, fuse_opt):
        cfg = NitroConfig(
            blocks=(BlockSpec("conv", 8, pool=True, dropout=0.25, d_lr=64),
                    BlockSpec("conv", 8, pool=True, d_lr=32), BlockSpec("linear", 16)),
            input_shape=(8, 8, 3), num_classes=10, gamma_inv=512, name="tiny-trace")
        state = tles.create_train_state(prng.PRNGKey(3), cfg, device="cpu")
        x = torch.from_numpy(np.stack(_images(6, seed=3)))
        y = torch.arange(6) % 10
        key = prng.PRNGKey(11)
        plain = tles.train_step(state, cfg, x, y, key, fuse_opt=fuse_opt, backend="reference")
        tr = Tracer()
        with otrace.use(tr):
            traced = tles.train_step(state, cfg, x, y, key, fuse_opt=fuse_opt,
                                     backend="reference")
        for a, b in zip(_tensor_leaves(plain), _tensor_leaves(traced), strict=True):
            assert torch.equal(a, b)
        edges, named = _tree(tr.snapshot())
        n = len(cfg.blocks)
        assert [s.attrs for s in named["step.train"]] == [{"fuse_opt": fuse_opt}]
        assert ("step.train", None) in edges
        assert edges.count(("step.forward", "step.train")) == 1
        assert edges.count(("step.output", "step.train")) == 1
        assert edges.count(("blocks.forward", "step.forward")) == n
        assert [(s.attrs["block"], s.attrs["kind"]) for s in named["blocks.forward"]] == [
            (i, b.kind) for i, b in enumerate(cfg.blocks)]
        assert edges.count(("step.block", "step.train")) == n
        assert edges.count(("blocks.learning", "step.block")) == n
        assert edges.count(("blocks.fw_update", "step.block")) == n
        assert edges.count(("dispatch.fused_conv_fwd", "blocks.forward")) == 2
        assert edges.count(("dispatch.fused_matmul_fwd", "blocks.forward")) == 1
        upd = "conv_grad_w_opt" if fuse_opt else "conv_grad_w"
        assert edges.count((f"dispatch.{upd}", "blocks.fw_update")) == 2
        assert ("dispatch.int_matmul", "blocks.learning") in edges
        assert edges.count(("step.apply", "step.train")) == (0 if fuse_opt else 1)
        assert not any(name.startswith("kernel.") for name in named)  # no CUDA wrapper here

    def test_plan_logits_records_each_layer(self):
        fm = _frozen()
        plan = compile_plan(fm, device="cpu")
        x = torch.from_numpy(np.stack(_images(4)))
        plain = plan.logits(x)
        tr = Tracer()
        with otrace.use(tr):
            traced = plan.logits(x)
        assert torch.equal(plain, traced)
        edges, named = _tree(tr.snapshot())
        assert edges.count(("plan.logits", None)) == 1
        assert [s.attrs for s in named["plan.layer"]] == [
            {"layer": i, "kind": m.kind} for i, m in enumerate(plan.metas)]
        assert all(parent == "plan.logits" for name, parent in edges if name == "plan.layer")
        assert sum(parent == "plan.layer" and name.startswith("dispatch.")
                   for name, parent in edges) == len(plan.metas)

    def test_train_cli_trace_holds_the_step_spans(self, tmp_path):
        """``--trace-out`` installs its tracer: each ``train.step`` holds
        the step's own spans."""
        from repro_torch.launch.train import main

        path = tmp_path / "trace.jsonl"
        main(["--arch", "vgg8b", "--steps", "2", "--batch", "8", "--scale", "0.0625",
              "--device", "cpu", "--trace-out", str(path)])
        rows = [json.loads(ln) for ln in path.read_text().splitlines()]
        by_id = {r["span_id"]: r for r in rows}
        parents = [by_id[r["parent_id"]]["name"] for r in rows
                   if r["name"] == "step.train" and r["parent_id"] in by_id]
        assert parents == ["train.step", "train.step"]
        assert {"step.forward", "blocks.forward", "blocks.learning",
                "dispatch.fused_conv_fwd"} <= {r["name"] for r in rows}
        assert otrace.active() is NULL_TRACER


class TestTracerBind:
    def test_bound_span_is_equivalent_to_span(self):
        tracer = Tracer()
        bound = tracer.bind("hot.path")
        with bound(step=1):
            pass
        with bound():
            pass
        with tracer.span("hot.path", step=3):
            pass
        spans = tracer.snapshot()
        assert [s.name for s in spans] == ["hot.path"] * 3
        assert [s.attrs for s in spans] == [{"step": 1}, {}, {"step": 3}]

    def test_bound_span_nests_like_span(self):
        tracer = Tracer()
        inner = tracer.bind("inner")
        with tracer.span("outer") as outer_id:
            with inner() as inner_id:
                pass
        by_name = {s.name: s for s in tracer.snapshot()}
        assert by_name["inner"].parent_id == outer_id
        assert by_name["inner"].span_id == inner_id

    def test_null_tracer_bind_is_free(self):
        with NULL_TRACER.bind("x")(step=1) as span_id:
            assert span_id == 0
        assert NULL_TRACER.snapshot() == []


# ---------------------------------------------------------------------------
# serving integration: metrics-enabled registry + fleet
# ---------------------------------------------------------------------------


def _counter_samples(reg, names):
    snap = reg.json_snapshot()
    return {n: sorted((tuple(sorted(s["labels"].items())), s["value"])
                      for s in snap[n]["samples"]) for n in names if n in snap}


class TestServingMetrics:
    def test_registry_lifecycle_metrics(self):
        reg = MetricRegistry()
        registry = ModelRegistry(device="cpu", backend="reference", metrics=reg)
        registry.register("m", _frozen())
        registry.swap("m", _frozen(seed=1))
        text = reg.prometheus_text()
        assert 'serve_model_swaps_total{model="m"} 1' in text
        assert 'serve_model_version{model="m"} 1' in text
        assert 'serve_model_events_total{event="register",model="m"} 1' in text
        assert 'serve_model_events_total{event="swap",model="m"} 1' in text
        registry.evict("m")
        assert 'serve_model_events_total{event="evict",model="m"} 1' in reg.prometheus_text()

    def test_fleet_queue_depth_batch_fill_and_spans(self):
        reg = MetricRegistry()
        registry = ModelRegistry(device="cpu", backend="reference", metrics=reg)
        registry.register("m", _frozen())
        tracer = Tracer()
        with FleetEngine(registry, batch_size=4, tracer=tracer) as engine:
            assert engine.metrics is reg  # inherited from the registry
            futs = [engine.submit(im, model="m") for im in _images(6)]
            assert all(f.result(timeout=T) for f in futs)
        text = reg.prometheus_text()
        assert 'serve_requests_total{model="m"} 6' in text
        assert 'serve_requests_total{model="_fleet"} 6' in text
        assert 'serve_queue_depth{model="m"} 0' in text  # drained
        fill = reg.json_snapshot()["serve_batch_fill"]["samples"][0]
        assert fill["count"] >= 2  # 6 requests through batch_size 4
        spans = tracer.snapshot()
        assert {s.name for s in spans} == {"fleet.assemble", "fleet.dispatch",
                                           "fleet.fetch", "fleet.deliver"}
        assert {s.attrs.get("model") for s in spans} == {"m"}
        for name in ("fleet.assemble", "fleet.dispatch", "fleet.fetch", "fleet.deliver"):
            assert sum(s.name == name for s in spans) == fill["count"]

    def test_vision_engine_metrics(self):
        from repro_torch.infer import compile_plan
        reg = MetricRegistry()
        plan = compile_plan(_frozen(), device="cpu", backend="reference")
        with VisionEngine(plan, batch_size=4, max_wait_ms=1.0, metrics=reg) as engine:
            futs = [engine.submit(im) for im in _images(5)]
            assert len([f.result(timeout=T) for f in futs]) == 5
        assert 'serve_requests_total{model="tiny-obs"} 5' in reg.prometheus_text()

    def test_fleet_slo_metrics(self):
        from repro_torch.serving import Slo
        reg = MetricRegistry()
        registry = ModelRegistry(device="cpu", backend="reference", metrics=reg)
        registry.register("m", _frozen(), slo=Slo(deadline_ms=60_000))
        with FleetEngine(registry, batch_size=4) as engine:
            engine.classify(_images(5), model="m")
        snap = reg.json_snapshot()
        assert snap["serve_slo_violations_total"]["samples"][0]["value"] == 0
        assert snap["serve_slo_deadline_seconds"]["samples"][0]["value"] == 60.0
        assert snap["serve_request_deadline_seconds"]["samples"][0]["count"] == 5

    def test_serving_counters_match_jax(self):
        """The same frozen weights and requests through both packages'
        registry + fleet on a shared MetricRegistry count the same samples.
        Batches are made deterministic: a long coalescing window holds the
        idle worker until a full batch is queued, each full batch is
        awaited, and the partial tail is drained by ``close``."""
        jcfg = tiny_cfg(JNitroConfig, JBlockSpec)
        names = ("serve_requests_total", "serve_batches_total", "serve_padded_slots_total",
                 "serve_model_swaps_total", "serve_model_events_total", "serve_model_version",
                 "serve_queue_depth")
        imgs = _images(15, seed=3)

        def serve(engine_cls, registry, model, batch):
            labels = []
            with engine_cls(registry, batch_size=4, coalesce_ms=1e6) as engine:
                full = len(batch) - len(batch) % 4
                for i in range(0, full, 4):
                    futs = [engine.submit(im, model=model) for im in batch[i:i + 4]]
                    labels += [f.result(timeout=T).label for f in futs]
                tail = [engine.submit(im, model=model) for im in batch[full:]]
            return labels + [f.result(timeout=T).label for f in tail]

        samples = {}
        for pkg in ("torch", "jax"):
            if pkg == "torch":
                reg = MetricRegistry()
                registry = ModelRegistry(device="cpu", backend="reference", metrics=reg)
                fm = [_frozen(0), _frozen(1)]
                engine_cls = FleetEngine
            else:
                reg = jmetrics.MetricRegistry()
                registry = JModelRegistry(backend="reference", metrics=reg)
                fm = [j_freeze(jles.create_train_state(jax.random.PRNGKey(s), jcfg), jcfg)
                      for s in (0, 1)]
                engine_cls = JFleetEngine
            registry.register("a", fm[0])
            registry.register("b", fm[0])
            labels = serve(engine_cls, registry, "a", imgs[:9])
            registry.swap("b", fm[1])
            labels += serve(engine_cls, registry, "b", imgs[9:])
            registry.evict("a")
            samples[pkg] = (_counter_samples(reg, names), labels)
        assert samples["torch"] == samples["jax"]
        counts = dict(samples["torch"][0]["serve_batches_total"])
        assert counts[(("model", "_fleet"),)] == 5  # 4 + 4 + 1 and 4 + 2


# ---------------------------------------------------------------------------
# CLI integration
# ---------------------------------------------------------------------------


class TestCliIntegration:
    def test_serve_cli_metrics_endpoint(self, capsys, tmp_path):
        from repro_torch.launch import serve_vision
        trace_path = str(tmp_path / "serve_trace.jsonl")
        res = serve_vision.main([
            "--train-steps", "0", "--scale", "0.0625", "--device", "cpu",
            "--requests", "12", "--batch", "4", "--metrics-port", "0",
            "--trace-out", trace_path])
        out = capsys.readouterr().out
        assert "[metrics] Prometheus text at http://127.0.0.1:" in out
        assert "[metrics] scraped" in out
        assert 'repro_build_info{version="0.8.0",backend="cpu"} 1' in out
        assert "serve_queue_depth" in out
        assert 'serve_requests_total{model="_fleet"} 13' in out  # warm-up included
        with open(trace_path) as f:
            rows = [json.loads(ln) for ln in f]
        assert {r["name"] for r in rows} == {"fleet.assemble", "fleet.dispatch",
                                             "fleet.fetch", "fleet.deliver"}
        assert res["metrics"] is not None and res["tracer"] is not None

    def test_serve_cli_static_scheduler_metrics(self, capsys):
        from repro_torch.launch import serve_vision
        serve_vision.main(["--scale", "0.0625", "--device", "cpu", "--requests", "6",
                           "--batch", "4", "--scheduler", "static", "--metrics-port", "0"])
        out = capsys.readouterr().out
        assert 'serve_requests_total{model="vgg8b"} 7' in out

    def test_train_cli_telemetry_jsonl(self, tmp_path, capsys):
        from repro_torch.launch.train import main
        telem = str(tmp_path / "metrics.jsonl")
        trace = str(tmp_path / "trace.jsonl")
        result = main(["--arch", "vgg8b", "--steps", "4", "--batch", "8", "--scale", "0.0625",
                       "--device", "cpu", "--telemetry-every", "2", "--telemetry-out", telem,
                       "--trace-out", trace])
        assert result["steps"] == 4 and "scaled_loss" in result
        with open(telem) as f:
            rows = [json.loads(ln) for ln in f]
        assert sorted({r["step"] for r in rows}) == [0, 2]
        assert {"_opt", "output"} <= {r["layer"] for r in rows}
        with open(trace) as f:
            names = [json.loads(ln)["name"] for ln in f]
        assert names.count("train.step") == 4 and "train.eval" in names
        assert f"[telemetry] every 2 steps -> {telem}" in capsys.readouterr().out


class TestTrainCliHealth:
    def test_train_cli_metrics_port_and_alerts(self, tmp_path, capsys):
        from repro_torch.launch.train import train_nitro
        result = train_nitro(
            "mlp1", steps=4, batch=8, scale=0.05, device="cpu", telemetry_every=2,
            telemetry_out=str(tmp_path / "metrics.jsonl"), metrics_port=0,
            alerts_out=str(tmp_path / "alerts.jsonl"))
        assert result["health"]["steps_observed"] == 2  # sampled steps
        assert result["straggler_events"] >= 0
        assert "[metrics] serving http://127.0.0.1:" in capsys.readouterr().out

    def test_default_telemetry_out_sits_beside_the_checkpoints(self, tmp_path, monkeypatch):
        from repro_torch.launch.train import train_nitro
        monkeypatch.chdir(tmp_path)
        train_nitro("mlp1", steps=2, batch=8, scale=0.05, device="cpu",
                    telemetry_every=1, ckpt_dir=str(tmp_path / "ckpt"))
        assert (tmp_path / "ckpt" / "metrics.jsonl").exists()

    def test_train_cli_serves_its_registry_while_it_runs(self, tmp_path):
        """The server answers during the run and is closed after it."""
        from repro_torch.launch import train as ttrain
        from repro_torch.obs import metrics as m

        seen = {}
        real = m.MetricsServer.close

        def close(server):
            seen["metrics"] = _get(server.url)[1].decode()
            seen["healthz"] = _get(f"http://{server.host}:{server.port}/healthz")
            real(server)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(m.MetricsServer, "close", close)
            ttrain.train_nitro("mlp1", steps=3, batch=8, scale=0.05, device="cpu",
                               metrics_port=0)
        assert "train_step_seconds_count 3" in seen["metrics"]
        assert 'repro_build_info{version="0.8.0",backend="cpu"} 1' in seen["metrics"]
        assert seen["healthz"] == (200, b"ok\n")
