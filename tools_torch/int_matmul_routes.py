#!/usr/bin/env python3
"""``int_matmul``'s three routes on the card: each held bitwise against
``int_matmul_ref``, then timed where the route rule draws its lines.

    python3 tools_torch/int_matmul_routes.py          # from a checkout, one CUDA card
    python3 tools_torch/int_matmul_routes.py check    # build and hold only

Prints, beside the card's name and power limit:

  * ``[ptxas]``: registers, spills and shared memory of the library's
    kernels (route W's consumers take 232 registers through setmaxnreg);
  * ``[routes-check]``: every route at ragged, deep and thin cases, twice
    each, bitwise, the route taken beside ``plan``'s;
  * ``[routes-lm]``: the LM's two int8 shapes: route W on a K-major b,
    route W on an N-major b (its transpose pass on its own), route D on the
    N-major b (the digit GEMM, unchanged from the parent) and
    ``torch._int_mm``; device time from the profiler, the bound and the
    share of it;
  * ``[routes-edge]``: route T against route D (forced through
    ``run_route``) on int32 operands at the thin edges (M = 4,096, K =
    2,048 and N of 8 to 128; M = 4,096, N = 512 and K of 16 to 128; a
    side of 64 and the work around 2²⁵ multiply-adds; the evaluation's and
    the materialise convs' thin shapes), and route T against route W on
    int8 operands with a K-major b, each beside the rule's choice;
  * ``[routes-step]``: one VGG8B training step's 23 calls (full width,
    batch 64, the views the step passes) on route T and on route D: device
    time, device launches, back-to-back time.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_OPS = 1979e12   # int8 dense ops/s, H100 SXM data sheet
PEAK_BYTES = 3.35e12  # device memory bytes/s, H100 SXM data sheet
LM_INT8 = [(2048, 2048, 8192), (2048, 8192, 2048)]
#: the learning and output layers' fan-ins of a VGG8B step (grad_x or not)
VGG8B_FAN_INS = [(1024, False), (3200, True), (4096, True), (4096, True), (2048, True),
                 (2048, True), (2048, True), (1024, True)]


def die(msg: str) -> None:
    print(f"[routes] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def profile(fn, calls: int) -> dict:
    """{kernel name: (device ms per call, launches per call)} of ``calls``
    runs of ``fn``, from the profiler (a profiled run with no device event
    is repeated)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in p.key_averages():
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            if us > 0:
                out[e.key] = (us / 1e3 / calls, e.count / calls)
        if out:
            return out
    die("the profiler saw no device time")


def total(parts: dict) -> tuple[float, float]:
    return sum(ms for ms, _ in parts.values()), sum(n for _, n in parts.values())


def back_to_back(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas(log: str) -> None:
    for entry in log.split("Compiling entry function")[1:]:
        name = entry.split("'")[1]
        short = next((k for k in ("gemm_s8_kernelILi256ELb0", "gemm_s8_kernelILi128ELb1",
                                  "thin_kernel", "transpose_s8_kernel", "matmul_digit_kernel")
                      if k in name), None)
        if short is None:
            continue
        r = re.search(r"Used (\d+) registers", entry)
        sp = re.search(r"(\d+) bytes spill stores", entry)
        sm = re.search(r"(\d+) bytes smem", entry)
        warn = "; setmaxnreg ignored" if "setmaxnreg ignored" in entry else ""
        print(f"[ptxas] {name[:60]}: {r and r.group(1)} registers, spill stores "
              f"{sp and sp.group(1)} B, {sm.group(1) if sm else 0} B static smem{warn}")
    if "C7508" in log or "setmaxnreg ignored" in log:
        print("[ptxas] warning: setmaxnreg ignored somewhere (see the build log)")


def routes_taken(fn) -> dict:
    from repro_torch.kernels.int_matmul import int_matmul_cuda

    before = {r: c.value for r, c in int_matmul_cuda.routes.items()}
    out = fn()
    return out, {r: c.value - before[r] for r, c in int_matmul_cuda.routes.items()
                 if c.value != before[r]}


def cases():
    """(label, a, b) on the card."""
    import torch

    g = torch.Generator().manual_seed(27)

    def ints(shape, lo, hi, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(dtype).cuda()

    out = []
    for m, k, n in LM_INT8:
        a = ints((m, k), -128, 128, torch.int8)
        bt = ints((n, k), -128, 128, torch.int8)
        out.append((f"LM ({m}x{k})x({k}x{n}) K-major b", a, bt.t()))
        out.append((f"LM ({m}x{k})x({k}x{n}) N-major b", a, bt.t().contiguous()))
    bt = ints((8200, 2064), -128, 128, torch.int8)
    out.append(("ragged W (2047x2064)x(2064x8200)", ints((2047, 2064), -128, 128, torch.int8),
                bt.t()))
    out.append(("ragged W N-major (1333x1040)x(1040x77)", ints((1333, 1040), -128, 128, torch.int8),
                ints((1040, 77), -128, 128, torch.int8)))
    a = torch.full((128, 131072), -128, dtype=torch.int8, device="cuda")
    out.append(("wrap K=131072 (128x131072)x(131072x144)", a,
                torch.full((144, 131072), -128, dtype=torch.int8, device="cuda").t()))
    out.append(("deep W K=40000 (200x40000)x(40000x300)", ints((200, 40000), -128, 128, torch.int8),
                ints((300, 40000), -128, 128, torch.int8).t()))
    w = ints((3000, 10), -2 ** 31, 2 ** 31)
    x = ints((64, 3000), -2 ** 31, 2 ** 31)
    d = ints((64, 10), -2 ** 31, 2 ** 31)
    out.append(("thin fwd (64x3000)x(3000x10)", x, w))
    out.append(("thin grad_x (64x10)x(10x3000) w.T", d, w.T))
    out.append(("thin grad_W (3000x64)x(64x10) x.T", x.T, d))
    out.append(("thin int8 (5x77)x(77x130) x int32", ints((5, 77), -128, 128, torch.int8),
                ints((77, 130), -2 ** 31, 2 ** 31)))
    out.append(("thin K=27 (65536x27)x(27x128)", ints((65536, 27), -127, 128),
                ints((27, 128), -64, 65)))
    out.append(("D int32 (1024x4608)x(4608x512)", ints((1024, 4608), -127, 128),
                ints((4608, 512), -64, 65)))
    return out


def check() -> None:
    import torch

    from repro_torch.core.numerics import int_matmul_ref
    from repro_torch.kernels.int_matmul import int_matmul_cuda, plan

    for label, a, b in cases():
        want = int_matmul_ref(a, b)
        rule = plan(tuple(a.shape), a.dtype, a.stride(), a.data_ptr(),
                    tuple(b.shape), b.dtype, b.stride(), b.data_ptr())
        for rep in (1, 2):
            got, took = routes_taken(lambda: int_matmul_cuda(a, b))
            torch.cuda.synchronize()
            if got.dtype != torch.int32 or not torch.equal(got, want):
                bad = int((got.long() != want.long()).sum())
                die(f"{label} #{rep}: {bad} of {want.numel()} values differ (route {took})")
            if list(took) != [{"WT": "W"}.get(rule, rule)]:
                die(f"{label}: took {took}, the rule says {rule}")
        print(f"[routes-check] {label}: route {rule}, bitwise twice")


def lm_timing(card: str) -> None:
    import torch

    from repro_torch.kernels.int_matmul import int_matmul_cuda, run_route
    from repro_torch.kernels.int_matmul.int_matmul import transpose_int8

    g = torch.Generator().manual_seed(12)
    for m, k, n in LM_INT8:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).cuda()
        bn = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8).cuda()
        bk = bn.t().contiguous().t()  # the same values, K-major
        o_ms, b_ms = 2 * m * k * n / PEAK_OPS * 1e3, (m * k + k * n + 4 * m * n) / PEAK_BYTES * 1e3
        bound = max(o_ms, b_ms)
        for rep in (1, 2):
            w_k, _ = total(profile(lambda: int_matmul_cuda(a, bk), 20))
            wt_parts = profile(lambda: int_matmul_cuda(a, bn), 20)
            wt, _ = total(wt_parts)
            stream = torch.cuda.current_stream().cuda_stream
            tr, _ = total(profile(lambda: transpose_int8(bn, stream), 20))
            d_parts = profile(lambda: run_route("D", a, bn), 10)
            d, _ = total(d_parts)
            lib, _ = total(profile(lambda: torch._int_mm(a, bk), 20))
            print(f"[routes-lm] {card} | ({m}x{k})x({k}x{n}) #{rep} | route W, K-major b "
                  f"{w_k:.4f} ms ({100 * bound / w_k:.1f}% of the {bound:.5f} ms "
                  f"{'operations' if o_ms >= b_ms else 'bytes'} bound) | route W, N-major b "
                  f"{wt:.4f} ms (transpose pass alone {tr:.4f}) | route D {d:.4f} ms ("
                  + ", ".join(f"{name[:28]} {ms:.4f}" for name, (ms, _) in sorted(
                      d_parts.items(), key=lambda kv: -kv[1][0]))
                  + f") | torch._int_mm {lib:.4f} ms")


def edge_timing(card: str) -> None:
    import torch

    from repro_torch.kernels.int_matmul import plan, run_route

    g = torch.Generator().manual_seed(13)

    def ints(shape, lim=2 ** 20, dtype=torch.int32):
        return torch.randint(-lim, lim, shape, generator=g, dtype=torch.int32).to(dtype).cuda()

    def rule(a, b):
        return plan(tuple(a.shape), a.dtype, a.stride(), a.data_ptr(),
                    tuple(b.shape), b.dtype, b.stride(), b.data_ptr())

    # int32: T against D
    shapes = [(4096, 2048, n) for n in (8, 16, 32, 64, 128)] + \
             [(4096, k, 512) for k in (16, 32, 64, 128)] + \
             [(64, 2048, n) for n in (16, 32, 64, 256)] + \
             [(64, 4096, 256), (64, 8192, 128), (128, 2048, 128), (64, 16, 4096),
              (65536, 27, 128), (27, 8192, 128), (8192, 1152, 3)]
    for m, k, n in shapes:
        a, b = ints((m, k)), ints((k, n))
        if not torch.equal(run_route("T", a, b), run_route("D", a, b)):
            die(f"routes T and D disagree at ({m}x{k})x({k}x{n})")
        t, _ = total(profile(lambda: run_route("T", a, b), 10))
        d, _ = total(profile(lambda: run_route("D", a, b), 10))
        print(f"[routes-edge] {card} | int32 ({m}x{k})x({k}x{n}) | route T {t:.4f} ms | "
              f"route D {d:.4f} ms | {'T' if t <= d else 'D'} faster | the rule: {rule(a, b)}")
    # int8 with a K-major b: T against W
    for m, k, n in [(64, 2048, 64), (64, 2048, 256), (64, 4096, 1024), (16, 2048, 2048),
                    (128, 2048, 128), (4096, 32, 512), (4096, 64, 512)]:
        a, b = ints((m, k), 128, torch.int8), ints((n, k), 128, torch.int8).t()
        if not torch.equal(run_route("T", a, b), run_route("W", a, b)):
            die(f"routes T and W disagree at ({m}x{k})x({k}x{n})")
        t, _ = total(profile(lambda: run_route("T", a, b), 10))
        w, _ = total(profile(lambda: run_route("W", a, b), 10))
        print(f"[routes-edge] {card} | int8, b K-major ({m}x{k})x({k}x{n}) | route T {t:.4f} ms | "
              f"route W {w:.4f} ms | {'T' if t <= w else 'W'} faster | the rule: {rule(a, b)}")


def step_timing(card: str) -> None:
    import torch

    from repro_torch.kernels.int_matmul import int_matmul_cuda, run_route

    g = torch.Generator().manual_seed(14)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32).cuda()

    calls = []
    for k, grad_x in VGG8B_FAN_INS:
        x, w = ints((64, k), -127, 128), ints((k, 10), -9, 10)
        delta = ints((64, 10), -2 ** 22, 2 ** 22)
        calls.append((x, w))
        if grad_x:
            calls.append((delta, w.T))
        calls.append((x.T, delta))
    if len(calls) != 23:
        die(f"{len(calls)} calls, not 23")
    for label, fn in (("route T", int_matmul_cuda), ("route D", lambda a, b: run_route("D", a, b))):
        step = lambda: [fn(a, b) for a, b in calls]  # noqa: E731
        dev, launches = total(profile(step, 10))
        print(f"[routes-step] {card} | one VGG8B step's 23 int_matmul calls on {label}: device "
              f"{dev:.4f} ms over {launches:.0f} device launches | back to back "
              f"{back_to_back(step):.4f} ms")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        die("this script runs on a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card)
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    logs = cuda_lib.build_all(["int_matmul"])
    print(f"[build] int_matmul in {time.perf_counter() - t0:.1f}s")
    ptxas(logs.get("int_matmul", ""))
    check()
    if sys.argv[1:] != ["check"]:
        lm_timing(card)
        edge_timing(card)
        step_timing(card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
