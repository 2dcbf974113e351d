"""The reading of a profiled stretch, on a trace written by hand: the
stretch between the marker kernels, the union of device intervals, an
entry point's calls (memset and pre-passes before its GEMM), the idle gaps
named by the host span open at their start, and the result line."""

from __future__ import annotations

import json

import pytest

from perfbench import harness, work


def _op(name, ts, dur, cat="kernel", stream=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream, "device": 0}}


GEMM = "void nitro::conv::conv_digit_gemm_kernel<(anonymous namespace)::FwdOut>(x)"
STEP = [  # one step of 100 µs: a call of #7 (memset, pre-pass, GEMM), a torch op, NCCL
    ("Memset (Device)", 0, 2, "gpu_memset"),
    ("void nitro::conv::x_digits_kernel<false>(y)", 2, 8, "kernel"),
    (GEMM, 10, 40, "kernel"),
    ("void at::native::elementwise_kernel<128, 2>(z)", 50, 10, "kernel"),
    ("ncclDevKernel_AllReduce_Sum_i32_RING_LL(w)", 70, 20, "kernel"),
]


def _trace(tmp_path, steps=3):
    ev = [_op("at::cuda::spin_kernel(long)", 1000.0, 5.0)]
    for s in range(steps):
        base = 1010.0 + 100.0 * s
        ev += [_op(n, base + t, d, c) for n, t, d, c in STEP]
    ev.append(_op("at::cuda::spin_kernel(long)", 1010.0 + 100.0 * steps, 5.0))
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "dur": 1.0})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    # host spans on perf_counter seconds: the opening marker launched at 5.0 s
    spans = [("train_step", 5.0 + 55e-6 + 100e-6 * s, 5.0 + 75e-6 + 100e-6 * s)
             for s in range(steps)]
    return harness.read_trace(str(path), steps, spans, 5.0)


def test_stretch_busy_and_launches(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window_s == pytest.approx(315e-6)
    # per step: [0, 60) and [70, 90) busy; the markers 5 µs each
    assert tr.busy_s == pytest.approx((3 * 80 + 10) * 1e-6)
    assert tr.launches() == 3 * 5


def test_a_lost_marker_leaves_the_stretch(tmp_path):
    _trace(tmp_path)
    ev = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ev = [e for e in ev if not ("spin_kernel" in e["name"] and e["ts"] > 1100)]
    path = tmp_path / "lost.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = harness.read_trace(str(path), 3, [], 5.0)
    assert tr.start == 1000.0 and tr.end == pytest.approx(1010.0 + 200 + 90)


def test_entry_calls_take_their_memset_and_prepasses(tmp_path):
    tr = _trace(tmp_path)
    s, calls = harness.entry_device_s(tr, [("conv_digit_gemm_kernel", "FwdOut")],
                                      [("x_digits_kernel",)])
    assert calls == 3 and s == pytest.approx(3 * 50e-6)
    assert harness.entry_device_s(tr, [("digit_gemm_kernel<true>",)], [])[1] == 0


def test_roofline_share_and_the_call_count_guard(tmp_path):
    tr = _trace(tmp_path)
    one = (work.PEAK_OPS * 25e-6, 0.0)  # a call whose bound is 25 µs
    readings = {"work": {"entries": {"stream_conv_fwd": [one]}}}
    pct = harness.roofline_pct(readings, tr, "stream_conv_fwd",
                               [("conv_digit_gemm_kernel", "FwdOut")], [("x_digits_kernel",)])
    assert pct == pytest.approx(50.0)
    readings = {"work": {"entries": {"stream_conv_fwd": [one] * 3}}}  # 9 calls expected
    assert harness.roofline_pct(readings, tr, "stream_conv_fwd",
                                [("conv_digit_gemm_kernel", "FwdOut")], []) is None
    readings = {"work": {"entries": {"stream_conv_fwd": [one, (0.0, 0.0)]}}}
    pct = harness.roofline_pct(readings, tr, "stream_conv_fwd",
                               [("conv_digit_gemm_kernel", "FwdOut")], [("x_digits_kernel",)])
    assert pct == pytest.approx(100 * (3 * 12.5e-6) / (3 * 50e-6))  # 3 of 6 at the mean bound


def test_idle_gaps_named_by_the_open_host_span(tmp_path):
    tr = _trace(tmp_path)
    b = harness.breakdown(tr)
    assert b["device_ops"][0][0].startswith("void nitro::conv::conv_digit_gemm_kernel")
    assert all("spin_kernel" not in n for n, _ in b["device_ops"])
    names = {n for n, _ in b["idle_gaps"]}
    assert "train_step" in names  # the gaps at 60–70 µs of each step
    assert len(b["idle_gaps"]) <= 10


def test_metric_readers_on_the_trace(tmp_path):
    tr = _trace(tmp_path)
    r = {"kind": "dp_train", "steps": 100, "window_s": 2.0, "batch": 2048, "chips": 4,
         "host_step_s": 0.02, "work": {"train_ops_per_image": 10 ** 9}}
    assert harness.metric_reader("allreduce_ms.dp").read(r, tr) == pytest.approx(0.02)
    assert harness.metric_reader("launches_per_step.train").read(r, tr) == 5
    idle = harness.metric_reader("device_idle_pct.train").read(r, tr)
    assert idle == pytest.approx(100 * (1 - 250 / 315))
    mfu = harness.metric_reader("mfu.train").read(r, tr)
    assert mfu == pytest.approx(100 * 1e9 * 100 * 2048 / 2.0 / (work.PEAK_OPS * 4))
    assert harness.metric_reader("host_ms_per_step.train").read(r, tr) == pytest.approx(20.0)
    assert harness.metric_reader("mfu.infer").read(r, tr) is None


def test_result_line_puts_the_checks_last(tmp_path):
    cell = harness.resolve("vgg8b.train.b512")
    tr = _trace(tmp_path)
    out = harness.Outcome(
        e2e={"setup_s": 9.0, "train_images_per_s": 2e4, "train_step_ms_p95": 26.0,
             "peak_mem_gib": 6.2},
        readings={"kind": "train", "steps": 100, "window_s": 2.0, "batch": 512, "chips": 1,
                  "host_step_s": 0.02, "work": {"train_ops_per_image": 10 ** 9,
                                                 "entries": {}}},
        checks={"loss": (0.0, 0), "unequal": (0, 0)}, attempted=100, failed=0,
        memory_peak_bytes=123, trace=tr)
    dev = {"platform": "gpu", "kind": "card", "count": 1}
    res = harness.result_line(cell, out, False, dev)
    assert list(res)[-1] == "checks" and res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "train_images_per_s", "train_step_ms_p95",
                                   "peak_mem_gib"}
    traced = harness.result_line(cell, out, True, dev)
    assert "mfu.train" in traced["metrics"] and "setup_s" not in traced["metrics"]
    assert traced["device"]["busy_s"] == pytest.approx(tr.busy_s)
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    out = out._replace(checks={"unequal": (3, 0)})
    assert harness.result_line(cell, out, False, dev)["correct"] is False


@pytest.mark.parametrize("cell,family", [("vgg11b.train.b512", "vgg11b."),
                                         ("vgg8b.train-dp4.b2048", "dp.")])
def test_family_metrics_report_their_quantity(tmp_path, cell, family):
    """A cell of a family reports the driver's readings under the family's
    names, and its per-layer metrics are read by the quantity's readers."""
    c = harness.resolve(cell)
    tr = _trace(tmp_path)
    out = harness.Outcome(
        e2e={"setup_s": 9.0, "train_images_per_s": 2e4, "train_step_ms_p95": 26.0,
             "peak_mem_gib": 6.2},
        readings={"kind": "dp_train", "steps": 100, "window_s": 2.0, "batch": 2048,
                  "chips": 4, "host_step_s": 0.02,
                  "work": {"train_ops_per_image": 10 ** 9, "entries": {}}},
        checks={"unequal": (0, 0)}, attempted=100, failed=0, memory_peak_bytes=1, trace=tr)
    dev = {"platform": "gpu", "kind": "card", "count": c.chips}
    res = harness.result_line(c, out, False, dev)["metrics"]
    assert res[family + "train_images_per_s"]["value"] == 2e4
    assert res["train_step_ms_p95"]["value"] == 26.0  # one metric across the train cells
    assert "train_images_per_s" not in res
    traced = harness.result_line(c, out, True, dev)["metrics"]
    assert traced[family + "mfu.train"]["value"] == pytest.approx(
        harness.metric_reader("mfu.train").read(out.readings, tr))
    assert harness.quantity(family + "device_idle_pct.train", {"device_idle_pct.train"}) \
        == "device_idle_pct.train"
    with pytest.raises(KeyError):
        harness.quantity(family + "no_such_metric", {"device_idle_pct.train"})
