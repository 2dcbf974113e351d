#!/usr/bin/env python3
"""What bounds the conv grad_W digit GEMM on the card: its device time with
the tensor-core MMAs, or the staging copies, taken out.

    python3 tools_torch/digit_gemm_variants.py     # from a checkout, one CUDA card

Builds ``stream_conv_grad_w`` from copies of ``csrc_common/digit_gemm.cuh``
(under a temporary directory; the checkout is not touched), one per
variant, and times ``digit_gemm_kernel`` alone (``torch.profiler`` device
time, best of two runs of 10 calls) at VGG8B's conv 2 and conv 4 shapes
(batch 64, int8 x, δ of ±2²⁰: three digit products) and at conv 4 with δ
of ±100 (one product):

  * ``base``: the kernel as it is;
  * ``no_mma``: every mma.sync replaced by one xor (copies and ldmatrix
    stay): the time the staging takes alone;
  * ``no_copy``: no cp.async (the MMAs run on whatever shared memory
    holds): the time the fragment loads and MMAs take alone;
  * ``no_copy_B``: only the δ planes' copies taken out.

The variants' results are garbage; only their times are read.  Prints the
card's name and power limit, each variant's ptxas registers, then one line
per shape.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MMA = "for (int nt = 0; nt < 4; ++nt) mma_s8(acc[i + j][mt][nt], a[mt], b[j][nt]);"
COPY_A = "      cp16(as + (i * BM + r) * ROW + 16 * c, src, ok);"
COPY_B = "    cp16(bs + (j * BN + r) * ROW + 16 * c, src, ok);"
VARIANTS = {
    "base": [],
    "no_mma": [(MMA, "for (int nt = 0; nt < 4; ++nt) "
                     "acc[i + j][mt][nt][0] ^= a[mt][0] ^ b[j][nt][0];")],
    "no_copy": [(COPY_A, ""), (COPY_B, "")],
    "no_copy_B": [(COPY_B, "")],
}
SHAPES = [((64, 32, 32, 128, 256), 2 ** 20), ((64, 16, 16, 256, 512), 2 ** 20),
          ((64, 16, 16, 256, 512), 100)]


def build(tmp: Path) -> dict[str, ctypes.CDLL]:
    """One stream_conv_grad_w library per variant, built in parallel."""
    from repro_torch.kernels import cuda_lib

    common = ROOT / "src" / "repro_torch" / "kernels" / "csrc_common"
    header = (common / "digit_gemm.cuh").read_text()
    jobs = []
    for name, edits in VARIANTS.items():
        text = header
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: the header no longer has {old!r}")
            text = text.replace(old, new)
        d = tmp / name
        d.mkdir()
        for h in common.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "digit_gemm.cuh").write_text(text)
        flags = [str(d) if a == str(common) else a for a in cuda_lib.NVCC_FLAGS]
        out = d / "lib.so"
        cmd = [cuda_lib.nvcc_path(), *flags, "-o", str(out),
               str(cuda_lib.SOURCES["stream_conv_grad_w"])]
        jobs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line][:1]
        print(f"[variant] {name}: digit_gemm_kernel {regs[0] if regs else ''}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def gemm_ms(call) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = float("inf")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if "digit_gemm" in e.key)
        best = min(best, us / 10 / 1e3)
    return best


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("digit_gemm_variants needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        g = torch.Generator().manual_seed(0)

        def ints(shape, lim):
            return torch.randint(-lim, lim, shape, generator=g).to(torch.int32).cuda()

        stream = torch.cuda.current_stream().cuda_stream
        for (n, h, w, c, f), lim in SHAPES:
            x, d, z = ints((n, h, w, c), 128), ints((n, h, w, f), lim), ints((n, h, w, f), 300)
            times = []
            for name, lib in libs.items():
                launch = lib.stream_conv_grad_w_launch
                launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                launch.restype = ctypes.c_int
                nbytes = lib.stream_conv_grad_w_scratch_bytes
                nbytes.argtypes, nbytes.restype = [ctypes.c_int] * 6, ctypes.c_longlong
                scratch = torch.empty(nbytes(n, h, w, c, f, 3), dtype=torch.uint8, device="cuda")
                out = torch.zeros((9 * c, f), dtype=torch.int32, device="cuda")
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                args = (x.data_ptr(), d.data_ptr(), z.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), n, h, w, c, f, 3, 10, sms, stream)
                if launch(*args):
                    raise SystemExit(f"variant {name}: launch failed")
                times.append(f"{name} {gemm_ms(lambda: launch(*args)):.4f}")
            print(f"[variant] x{(n, h, w, c)} delta +-{lim} F={f}: digit_gemm_kernel ms "
                  + " | ".join(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
