#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases, each fatal on failure:
  1. device and toolchain (nvidia-smi name/power limit, nvcc, torch, triton);
  2. build both CUDA kernels from the checkout's sources, in parallel, timed;
  3. hold each kernel against its plain PyTorch version on the card,
     bitwise (tolerance 0: every value is an integer), at every VGG8B step
     shape at batch 32 and at ragged / int32-operand shapes;
  4. the main path: ``repro_torch.launch.serve_vision.main`` serves
     full-width VGG8B (seeded random init → freeze → compile_plan →
     VisionEngine) with the launch counts reset just before and read just
     after; every request's logits must equal the ``backend='reference'``
     plan's, and each batch must launch stream_conv 6× and nitro_matmul 2×;
  5. time each kernel per step shape with CUDA events beside its bound,
     its plain version and the end-to-end batch latency.

Prints a ``{"kernels": [...]}`` line, in which ``ms``, ``plain_ms`` and
``bound_ms`` are one batch's launches of the kernel summed over its step
shapes and ``launches`` is the main path's count; then, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line,
when CUDA is absent or the script is not inside a checkout.

Bound: the larger of ops / 1,979 TOP/s (the H100's dense int8 peak) and
bytes / 3.35 TB/s (its memory rate), counting each input read once and
each output written once.  No single PyTorch call computes the fused
integer conv/matmul + NITRO scale + ReLU (+ pool), so ``library_ms`` is
null.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_OPS = 1979e12   # int8 dense ops/s, H100 SXM data sheet
PEAK_BYTES = 3.35e12  # device memory bytes/s, H100 SXM data sheet
BATCH = 32
REQUESTS = 64

KERNELS = {
    "nitro_matmul": {
        "source": "src/repro_torch/kernels/nitro_matmul/csrc/nitro_matmul.cu",
        "replaces": "src/repro/kernels/nitro_matmul/nitro_matmul.py:235",
    },
    "stream_conv": {
        "source": "src/repro_torch/kernels/nitro_conv/csrc/stream_conv.cu",
        "replaces": "src/repro/kernels/nitro_conv/nitro_conv.py:324",
    },
}


def die(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def toolchain(torch) -> str:
    """Phase 1: print the card and the toolchain; returns the card line."""
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card)
    from repro_torch.kernels import cuda_lib

    nvcc = run([cuda_lib.nvcc_path(), "--version"]).splitlines()
    try:
        from importlib.metadata import version
        triton = version("triton")
    except Exception:  # absent or unreadable metadata: report, not fatal
        triton = "absent"
    print(f"[env] {' / '.join(nvcc[-2:])} | torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}) | triton {triton} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def build() -> None:
    """Phase 2: compile every kernel library, one nvcc each, in parallel."""
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    logs = cuda_lib.build_all()
    print(f"[build] {sorted(logs) or 'cached'} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")


def run_step(meta, a, w, backend: str):
    """One plan step through the dispatcher with an explicit backend."""
    import torch
    from repro_torch.kernels.nitro_conv.ops import fused_conv
    from repro_torch.kernels.nitro_matmul.ops import fused_matmul

    out_dtype = torch.int8 if meta.out_dtype == "int8" else torch.int32
    kw = dict(sf=meta.sf, alpha_inv=meta.alpha_inv, apply_relu=meta.apply_relu,
              out_dtype=out_dtype, backend=backend,
              operand_dtype=meta.operand_dtype)
    if meta.kind == "conv":
        return fused_conv(a, w, pool=meta.pool, conv_mode=meta.conv_mode, **kw)
    return fused_matmul(a, w, **kw)


def step_inputs(plan, x):
    """(meta, input, weight) of every plan step on batch ``x`` (plain path)."""
    import torch

    a = torch.as_tensor(x).to(device=plan.device, dtype=torch.int32)
    steps = []
    for w, meta in zip(plan.weights, plan.metas):
        if meta.kind != "conv" and a.ndim > 2:
            a = a.reshape(a.shape[0], -1)
        steps.append((meta, a, w))
        a = run_step(meta, a, w, "reference")
    return steps


def compare(name: str, got, want, errs: dict) -> None:
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        die(f"{name}: {got.dtype}{tuple(got.shape)} vs plain "
            f"{want.dtype}{tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    kernel = name.split()[0]
    errs[kernel] = max(errs.get(kernel, 0), err)
    if err != 0:
        bad = (got != want).nonzero()[0].tolist()
        die(f"{name}: kernel != plain (max |err| {err}), first at {bad}")
    print(f"[parity] {name}: bitwise equal")


def parity(steps, errs: dict) -> None:
    """Phase 3: each kernel vs its plain version on the card, bitwise."""
    import torch
    from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv
    from repro_torch.kernels.nitro_conv.ref import stream_conv_ref
    from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul
    from repro_torch.kernels.nitro_matmul.ref import nitro_matmul_ref

    g = torch.Generator().manual_seed(1)
    dev = "cuda"

    def ints(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(dtype).to(dev)

    # each step shape twice: on the main path's own activations, and on
    # uniform [-127, 127] inputs of the same shape and dtype
    for i, (meta, a, w) in enumerate(steps, 1):
        kernel = "stream_conv" if meta.kind == "conv" else "nitro_matmul"
        for tag, inp in (("path", a), ("uniform", ints(a.shape, -127, 128, a.dtype))):
            got = run_step(meta, inp, w, "cuda")
            want = run_step(meta, inp, w, "reference")
            torch.cuda.synchronize()
            compare(f"{kernel} step {i} {tag} {tuple(a.shape)}x{tuple(w.shape)} "
                    f"operands={meta.operand_dtype}", got, want, errs)

    i32 = (-(2 ** 31), 2 ** 31)
    mm_cases = [  # (M, K, N, operand range, dtype, sf, alpha_inv, relu, out)
        (5, 7, 3, (-127, 128), torch.int8, 256 * 7, 10, True, torch.int8),
        (33, 300, 70, (-127, 128), torch.int8, 256 * 300, 2, True, torch.int32),
        (33, 300, 70, (-127, 128), torch.int8, 3 << 2, 10, True, torch.int32),
        (40, 64, 130, (-127, 128), torch.int8, 1, 3, True, torch.int32),
        (33, 2048, 10, i32, torch.int32, 27 << 8, 1, False, torch.int32),
        (64, 300, 70, i32, torch.int32, 6912, 10, True, torch.int8),
        (32, 1152, 256, (-127, 128), torch.int16, 9 << 15, 10, True, torch.int8),
    ]
    for m, k, n, rng, dt, sf, ai, relu, out in mm_cases:
        x, w = ints((m, k), *rng, dt), ints((k, n), *rng, dt)
        od = "int8" if dt == torch.int8 else "int32"
        kw = dict(sf=sf, alpha_inv=ai, apply_relu=relu, out_dtype=out, operand_dtype=od)
        got = nitro_matmul(x, w, **kw)
        want = nitro_matmul_ref(x, w, **kw)
        torch.cuda.synchronize()
        compare(f"nitro_matmul ragged ({m},{k},{n}) {dt} relu={relu} -> {out}",
                got, want, errs)

    conv_cases = [  # (N, H, W, C, F, K, pool, dtype, bh, out, sf)
        (3, 7, 9, 5, 40, 3, True, torch.int8, 8, torch.int8, 6),
        (2, 6, 10, 4, 20, 3, False, torch.int8, 4, torch.int32, 5),
        (2, 9, 7, 6, 33, 5, False, torch.int32, 8, torch.int32, 256 * 150),
        (2, 11, 13, 3, 16, 3, True, torch.int32, 2, torch.int8, 256 * 27),
        (4, 5, 5, 7, 10, 3, False, torch.int8, 3, torch.int8, 256 * 63),
        (2, 16, 100, 400, 40, 3, True, torch.int8, 8, torch.int8, 256 * 3600),
        (1, 12, 90, 150, 36, 3, False, torch.int8, 8, torch.int32, 3 << 10),
        (BATCH, 32, 32, 128, 256, 3, True, torch.int32, 8, torch.int8, 9 << 15),
        (BATCH, 8, 8, 512, 512, 3, True, torch.int32, 8, torch.int8, 9 << 17),
    ]
    for n, h, wd, c, f, k, pool, dt, bh, out, sf in conv_cases:
        x, w = ints((n, h, wd, c), -127, 128, dt), ints((k, k, c, f), -127, 128, dt)
        od = "int8" if dt == torch.int8 else "int32"
        kw = dict(sf=sf, alpha_inv=10, apply_relu=True, pool=pool,
                  out_dtype=out, operand_dtype=od)
        got = stream_conv(x, w, bh=bh, **kw)
        want = stream_conv_ref(x, w, bh=bh, **kw)
        torch.cuda.synchronize()
        compare(f"stream_conv ragged ({n},{h},{wd},{c})*K{k}->{f} {dt} "
                f"pool={pool} bh={bh}", got, want, errs)


def main_path():
    """Phase 4: the port's serving CLI at full width, counted."""
    import numpy as np
    import torch
    from repro_torch.infer import compile_plan
    from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv
    from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul
    from repro_torch.launch import serve_vision

    stream_conv.launches.reset()
    nitro_matmul.launches.reset()
    res = serve_vision.main([
        "--arch", "vgg8b", "--scale", "1", "--batch", str(BATCH),
        "--requests", str(REQUESTS), "--seed", "0", "--device", "cuda",
    ])
    launches = {"stream_conv": stream_conv.launches.value,
                "nitro_matmul": nitro_matmul.launches.value}
    batches = res["batches_total"]
    print(f"[main] {batches} batches, launches {launches}")
    if launches != {"stream_conv": 6 * batches, "nitro_matmul": 2 * batches}:
        die(f"expected 6 stream_conv + 2 nitro_matmul per batch over {batches} "
            f"batches, got {launches}")
    ref_plan = compile_plan(res["fm"], device="cuda", backend="reference")
    images, results = res["images"], res["results"]
    for s in range(0, len(images), BATCH):
        want = ref_plan.logits(np.stack(images[s:s + BATCH])).cpu().numpy()
        for j, r in enumerate(results[s:s + BATCH]):
            got = r.logits
            if got.dtype != np.int32 or got.shape != (10,) or not np.array_equal(got, want[j]):
                die(f"request {s + j}: logits {got} != reference {want[j]}")
            if r.label != int(np.argmax(want[j])):
                die(f"request {s + j}: label {r.label} != reference")
    print(f"[main] {len(results)} requests: logits equal the reference plan's")
    return res, launches


def time_cuda(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def work(meta, a, w, out_elems: int, out_itemsize: int):
    """(ops, bytes) of one launch: 2 ops per MAC, every operand read once
    and the output written once, in the dtypes the launch moves."""
    wi = 1 if meta.operand_dtype == "int8" else 4
    if meta.kind == "conv":
        n, h, wd, c = a.shape
        k, f = w.shape[0], w.shape[-1]
        macs = n * h * wd * k * k * c * f
    else:
        macs = a.shape[0] * a.shape[1] * w.shape[1]
    nbytes = a.numel() * a.element_size() + w.numel() * wi + out_elems * out_itemsize
    return 2 * macs, nbytes


def timing(steps, card: str) -> dict:
    """Phase 5: per-step kernel / plain / bound times."""
    per_kernel: dict[str, dict] = {}
    for i, (meta, a, w) in enumerate(steps, 1):
        kernel = "stream_conv" if meta.kind == "conv" else "nitro_matmul"
        out = run_step(meta, a, w, "cuda")
        ms = time_cuda(lambda: run_step(meta, a, w, "cuda"), iters=50, warmup=5)
        plain = time_cuda(lambda: run_step(meta, a, w, "reference"), iters=5, warmup=1)
        ops, nbytes = work(meta, a, w, out.numel(), out.element_size())
        ops_ms, bytes_ms = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"[time] {card} | step {i} {kernel} in{tuple(a.shape)} "
              f"w{tuple(w.shape)} operands={meta.operand_dtype} | kernel "
              f"{ms:.4f} ms | plain {plain:.4f} ms | bound {bound:.5f} ms "
              f"({by}: {ops / 1e9:.3f} Gop, {nbytes / 1e6:.3f} MB) | "
              f"{100 * bound / ms:.2f}% of bound | library none")
        k = per_kernel.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                           "ops_ms": 0.0, "bytes_ms": 0.0})
        k["ms"] += ms
        k["plain_ms"] += plain
        k["bound_ms"] += bound
        k["ops_ms"] += ops_ms
        k["bytes_ms"] += bytes_ms
    return per_kernel


def end_to_end(res, card: str) -> None:
    """Batch latency of the plan alone (host → logits on the host)."""
    import numpy as np

    plan = res["plan"]
    batch = np.stack(res["images"][:BATCH])
    ms = time_cuda(lambda: plan.logits(batch).cpu(), iters=20, warmup=3)
    snap = res["snapshot"]
    print(f"[e2e] {card} | plan batch of {BATCH}: {ms:.3f} ms "
          f"({BATCH / ms * 1e3:.1f} img/s) | engine: {len(res['results'])} "
          f"requests in {res['wall_s']:.3f} s ({len(res['results']) / res['wall_s']:.1f} "
          f"req/s), {snap['batches']} batches, fill {snap['avg_batch_fill']:.2f}, "
          f"latency ms p50 {res['latency_ms']['p50']:.2f} p99 {res['latency_ms']['p99']:.2f}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        die("src/repro_torch not found beside chip_smoke.py: run it from the "
            "root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        die(f"CUDA is not available (torch {torch.__version__}); this smoke "
            f"test runs only on a CUDA card")
    card = toolchain(torch)
    build()

    from repro_torch.configs import get_paper_config
    from repro_torch.core import model as M
    from repro_torch.infer import compile_plan, freeze

    import numpy as np

    cfg = get_paper_config("vgg8b", scale=1.0)
    fm = freeze(M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg)
    plan = compile_plan(fm, device="cuda")
    x = np.random.default_rng(0).integers(-127, 128, (BATCH, *cfg.input_shape)).astype(np.int32)
    steps = step_inputs(plan, x)

    errs: dict[str, int] = {}
    parity(steps, errs)
    res, launches = main_path()
    per_kernel = timing(steps, card)
    end_to_end(res, card)

    rows = []
    for name, meta in KERNELS.items():
        k = per_kernel[name]
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": "operations" if k["ops_ms"] >= k["bytes_ms"] else "bytes",
            "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
