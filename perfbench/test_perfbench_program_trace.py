"""The attribution of a profiled stretch to the program's spans, on a trace
written by hand: operations to the innermost span open at their launch on
the launching thread, the blocks' device time outside ``dispatch.*``,
span self times, host waits against device-side gaps, the first step left
out, no reading under 99% launch records, and the readers by name."""

from __future__ import annotations

import json
import sys
import time

import pytest
import torch

from perfbench import context, harness, program_trace
from repro_torch.obs.trace import Span

BASE = 10 ** 12                             # the trace's baseTimeNanoseconds
ANCHOR = (5 * 10 ** 9, BASE + 2 * 10 ** 9)  # (monotonic_ns, time_ns)
MAIN, OTHER = 77, 99                        # launching threads' ids in the trace
GEMM = "void nitro::conv::conv_digit_gemm_kernel<(anonymous namespace)::FwdOut>(x)"


def ns(us: float) -> int:
    """The monotonic time that the anchor carries to ``us`` on the trace."""
    return 3 * 10 ** 9 + int(round(us * 1000))


class _TraceWriter:
    def __init__(self):
        self.events, self.spans, self.corr, self.ids = [], [], 0, 0

    def span(self, name, a, b, parent=None, thread="MainThread", **attrs):
        self.ids += 1
        self.spans.append(Span(name, ns(a), ns(b), self.ids, parent, thread, attrs))
        return self.ids

    def op(self, name, launch, start, dur, cat="kernel", tid=MAIN, record=True):
        self.corr += 1
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": start, "dur": dur,
                            "args": {"correlation": self.corr, "stream": 7}})
        if record:
            self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                                "ts": launch, "dur": 1.0, "tid": tid,
                                "args": {"correlation": self.corr}})

    def mark(self, host, device):
        self.span(program_trace.MARK_SPAN, host, host + 4)
        self.op("at::cuda::spin_kernel(long)", host + 1, device, 2)

    def stretch(self, tmp_path, probe=None):
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": self.events}))
        return program_trace.read(str(path), self.spans, ANCHOR, "MainThread", probe)


def _train(tmp_path, steps=3, drop_record=False):
    """``steps`` steps of 200 µs from 1000 µs.  On the host a step is
    ``step.train`` ⊃ ``blocks.forward`` ⊃ ``dispatch.fused_conv_fwd`` ⊃
    ``kernel.stream_conv_fwd``; on the card each step is busy over
    [T+50, T+130) and [T+135, T+140), so that the card waits on the host
    110 µs between steps and 5 µs inside each on an operation queued long
    before.  Step 1 launches one more operation, outside every dispatch."""
    b = _TraceWriter()
    b.mark(900, 950)
    b.mark(905, 953)
    for s in range(steps):
        t = 1000 + 200 * s
        root = b.span("step.train", t, t + 100, fuse_opt=True)
        fwd = b.span("blocks.forward", t + 10, t + 60, root, block=0, kind="conv")
        disp = b.span("dispatch.fused_conv_fwd", t + 20, t + 40, fwd)
        b.span("kernel.stream_conv_fwd", t + 25, t + 35, disp)
        if s == 0:
            b.op("first_step_only", t + 8, t + 30, 5)
        b.op("elementwise_kernel", t + 5, t + 50, 10)
        b.op("pool_kernel", t + 15, t + 60, 10)
        b.op("direct_copy_kernel", t + 22, t + 70, 5)
        b.op("Memset (Device)", t + 26, t + 75, 2, cat="gpu_memset")
        b.op(GEMM, t + 27, t + 77, 40)
        b.op("stack_kernel", t + 70, t + 117, 8)
        b.op("other_thread_kernel", t + 30, t + 125, 5, tid=OTHER)
        b.op("tail_kernel", t + 28, t + 135, 5, record=not (drop_record and s == 1))
    b.mark(1600, 1700)
    b.mark(1605, 1703)
    return b.stretch(tmp_path)


def test_operations_go_to_the_innermost_span_open_at_launch(tmp_path):
    st = _train(tmp_path)
    owner = {}
    for o in st.ops:
        owner.setdefault(o.name, set()).add(None if o.span is None else st.spans[o.span].name)
    assert owner["elementwise_kernel"] == {"step.train"}
    assert owner["pool_kernel"] == {"blocks.forward"}
    assert owner["direct_copy_kernel"] == {"dispatch.fused_conv_fwd"}
    assert owner[GEMM] == owner["Memset (Device)"] == {"kernel.stream_conv_fwd"}
    assert owner["other_thread_kernel"] == {None}  # another thread: no span of its own
    assert st.coverage == 1.0 and st.start == 950 and st.end == 1705
    assert program_trace.busy_ms(st) == pytest.approx((90 + 85 + 85) / 1000)
    assert all("spin_kernel" not in o.name for o in st.ops)
    assert st.clock == (1.0, 2.0)  # each marker's launch inside its span


def test_innermost_breaks_ties_by_nesting():
    sp = [program_trace.PSpan("inner", 10.0, 20.0, 2, 1, "t"),
          program_trace.PSpan("outer", 10.0, 30.0, 1, None, "t"),
          program_trace.PSpan("empty", 25.0, 25.0, 3, 1, "t")]
    assert program_trace._innermost(sp, [10.0, 20.0, 25.0, 30.0, None]) == [0, 1, 1, None, None]


def test_blocks_exclude_dispatch_and_the_first_step(tmp_path):
    st = _train(tmp_path)
    # steps 2 and 3: elementwise 10 + pool 10 + stack 8 µs a step
    assert program_trace.blocks_device_ms(st) == pytest.approx(0.028)
    table = {r[0]: r for r in program_trace.span_table(st, 3)}
    # inside step.train: the blocks' 28 µs and dispatch's 5 + 2 + 40 (+ tail 5)
    assert table["step.train"][4] == pytest.approx((28 + 52) / 1000 + 0.005 / 3)
    assert table["dispatch.fused_conv_fwd"][3] == pytest.approx(0.005)


def test_the_exchange_is_not_the_blocks(tmp_path):
    """Under data parallelism the step launches the exchange's operations
    inside ``parallel.*`` spans: they count there, not in the blocks."""
    b = _TraceWriter()
    b.mark(900, 950)
    for s in range(2):
        t = 1000 + 200 * s
        root = b.span("step.train", t, t + 100)
        b.span("parallel.reduce_gradients", t + 40, t + 60, root, method="psum")
        b.op("elementwise_kernel", t + 5, t + 120, 10)
        b.op("ncclDevKernel_AllReduce", t + 45, t + 130, 30)
    b.mark(1600, 1700)
    st = b.stretch(tmp_path)
    assert program_trace.step_parts(st) == pytest.approx(
        {"step": 0.04, "blocks": 0.01, "dispatch.": 0.0, "parallel.": 0.03})
    assert program_trace.blocks_device_ms(st) == pytest.approx(0.01)


def test_self_time_takes_away_the_children(tmp_path):
    table = {r[0]: r for r in program_trace.span_table(_train(tmp_path), 3)}
    assert table["step.train"][1] == 1.0
    assert table["step.train"][2] == pytest.approx((100 - 50) / 1000)
    assert table["blocks.forward"][2] == pytest.approx((50 - 20) / 1000)
    assert table["dispatch.fused_conv_fwd"][2] == pytest.approx((20 - 10) / 1000)
    assert table["kernel.stream_conv_fwd"][2] == pytest.approx(10 / 1000)


def test_host_wait_against_device_side_gaps(tmp_path):
    st = _train(tmp_path)
    # from step 2's first operation (1250 µs) to the stretch's end (1705):
    # one wait on the host (1340–1450); the 5 µs gaps before tail_kernel
    # end on an operation launched long before, so they are the card's
    assert program_trace.host_wait_pct(st) == pytest.approx(100 * 110 / 455)
    rows = program_trace.gap_table(st)
    assert rows[0][0] == pytest.approx(110) and rows[0][2] == "step.train"
    assert rows[0][3] == pytest.approx(65)  # launched 65 µs after the gap began
    tail = [r for r in rows if r[0] == pytest.approx(5)]
    assert tail and all(r[2] == "kernel.stream_conv_fwd" and r[3] < 0 for r in tail)


def test_no_reading_under_99_percent_launch_records(tmp_path, capsys):
    st = _train(tmp_path, drop_record=True)
    assert st.coverage == pytest.approx(24 / 25)
    for name in program_trace.READINGS:
        assert program_trace.READINGS[name](st) is None
    program_trace.report(st, 3)
    assert "no reading" in capsys.readouterr().err


def test_dispatch_host_time_over_the_probe_outermost_only():
    probe = [Span("step.train", 0, 10_000_000, 1, None, "MainThread", {}),
             Span("dispatch.conv_grad_w", 1_000_000, 3_000_000, 2, 1, "MainThread", {}),
             Span("dispatch.int_matmul", 1_500_000, 2_000_000, 3, 2, "MainThread", {}),
             Span("dispatch.int_matmul", 5_000_000, 6_000_000, 4, 1, "MainThread", {}),
             Span("step.train", 20_000_000, 30_000_000, 5, None, "MainThread", {}),
             Span("dispatch.fused_conv_fwd", 21_000_000, 22_000_000, 6, 5, "MainThread", {})]
    st = program_trace.Stretch([], [], 0.0, 1.0, 1.0, (None, None), probe)
    assert program_trace.dispatch_host_ms(st) == pytest.approx((2 + 1 + 1) / 2)
    table = {r[0]: r[1:] for r in program_trace.probe_table(probe)}
    assert table["step.train"] == pytest.approx([1.0, (10 - 2 - 1 + 10 - 1) / 2])
    assert table["dispatch.conv_grad_w"] == pytest.approx([0.5, (2 - 0.5) / 2])


def test_roofline_tables_against_the_kernel_span(tmp_path):
    st = _train(tmp_path)
    rd = harness.metric_reader("stream_conv_fwd_roofline")
    assert program_trace.table_ops(st, rd.GEMM, rd.PREPASS) == (6, 3)
    assert program_trace.span_ops(st, "kernel.stream_conv_fwd") == (9, 3)  # + tail_kernel


def _plan(tmp_path):
    b = _TraceWriter()
    b.mark(900, 950)
    for i, (a, d) in enumerate(((1000, 300), (1400, 500))):
        root = b.span("plan.logits", a, a + d)
        b.span("plan.layer", a + 10, a + 100, root, layer=0, kind="conv")
        b.op("conv", a + 20, a + 600, 100)
    b.mark(2000, 2100)
    return b.stretch(tmp_path)


@pytest.mark.parametrize("metric,kind,want", [
    ("blocks_device_ms.train", "train", 0.028),
    ("vgg11b.blocks_device_ms.train", "train", 0.028),
    ("dp.blocks_device_ms.train", "dp_train", 0.028),
    ("host_wait_pct.train", "train", 100 * 110 / 455),
    ("vgg11b.host_wait_pct.train", "train", 100 * 110 / 455),
    ("dp.host_wait_pct.train", "dp_train", 100 * 110 / 455),
    ("plan_host_ms.infer", "infer", 0.4),
    ("blocks_device_ms.train", "infer", None),
    ("plan_host_ms.infer", "train", None),
])
def test_readers_by_name(tmp_path, monkeypatch, metric, kind, want):
    st = _plan(tmp_path) if metric.startswith("plan") else _train(tmp_path)
    monkeypatch.setattr(program_trace, "rebuilt", lambda r, first: st)
    got = harness.metric_reader(metric).read({"kind": kind}, None)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("metric", ["dispatch_host_ms.train", "vgg11b.dispatch_host_ms.train",
                                    "dp.dispatch_host_ms.train"])
def test_dispatch_readers_by_name(tmp_path, monkeypatch, metric):
    probe = [Span("step.train", 0, 10_000_000, 1, None, "MainThread", {}),
             Span("dispatch.int_matmul", 1_000_000, 4_000_000, 2, 1, "MainThread", {})]
    st = _train(tmp_path)._replace(probe=probe)
    monkeypatch.setattr(program_trace, "rebuilt", lambda r, first: st)
    r = {"kind": "dp_train" if metric.startswith("dp.") else "train"}
    assert harness.metric_reader(metric).read(r, None) == pytest.approx(3.0)


def test_no_second_stretch_outside_a_run_on_the_card():
    """Without ``run.py``'s arguments and a card (the CPU tests) the readers
    find nothing and run nothing."""
    assert program_trace.reading({"kind": "train"}, "blocks_device_ms", None) is None
    assert harness.metric_reader("plan_host_ms.infer").read({"kind": "infer"}, None) is None


def test_cost_line_sets_the_traced_stretch_beside_the_first(tmp_path):
    probe = [Span("step.train", 0, 3_000_000, 1, None, "MainThread", {}),
             Span("step.train", 5_000_000, 10_000_000, 2, None, "MainThread", {})]
    st = _train(tmp_path)._replace(probe=probe)
    first = harness.Trace([], [], 0.0, 3000.0, 3)
    line = program_trace.cost_line(st, first, 0.0035, 3)
    assert line.startswith("[cost]")
    assert "first stretch 1.0000 / 0.0000" in line
    assert f"traced {(1705 - 950) / 3000:.4f} / {0.26 / 3:.4f}" in line
    assert "first probe 3.5000, traced probe 4.0000" in line
    assert "probe" not in program_trace.cost_line(_plan(tmp_path), first, None, 3)


@pytest.fixture
def without_the_jax_package(monkeypatch):
    """This process's modules as a benchmark run's: a test worker may hold
    the JAX package and the JAX stack from other tests' files, so they are
    out of ``sys.modules`` for the test and back after it."""
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN_MODULES:
            monkeypatch.delitem(sys.modules, name)


@pytest.mark.usefixtures("without_the_jax_package")
@pytest.mark.parametrize("cell,traffic,fault", [
    ("vgg8b.train.b512", {}, None),
    ("vgg8b.train.b512", {}, "jax_package_loaded"),
    ("vgg8b.train-dp4.b2048", {"ranks": 2}, None),
    ("vgg8b.train-dp4.b2048", {"ranks": 2}, "jax_package_loaded"),
])
def test_second_stretch_that_loads_the_jax_package_gives_no_result(capsys, cell, traffic,
                                                                   fault):
    """``harness.finish`` looks for the forbidden modules before the readers
    run; a rebuilt cell that loads ``repro``, in this process or in a rank
    it started, ends the run with exit code 3 before any result.  Off a
    card the cell is built and warmed up and no stretch is taken."""
    ctx = context.Context.for_cell(
        harness.resolve(cell), seed=2 ** 31 + 7, seconds=0.3, trace=True,
        device=torch.device("cpu"), t_start=time.perf_counter(), scale=0.0625,
        traffic=dict({"batch": 8, "dataset_images": 40}, **traffic))
    capsys.readouterr()
    if fault is None:
        assert program_trace.second_stretch(ctx) is None
        assert "Traceback" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as e:
        program_trace.second_stretch(ctx, fault)
    assert e.value.code == 3
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "repro" in captured.err
    assert "repro" not in sys.modules
