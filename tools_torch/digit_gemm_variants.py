#!/usr/bin/env python3
"""What bounds the conv digit GEMMs on the card: their device time with the
tensor-core MMAs, the staging copies or the stores taken out; the matmul
digit GEMM's epilogue with its floor divides as multiply-highs (as
built) against divide instructions; the linear grad_W kernels with
their loads, their stores or the update's W tile changed; and the two
input-gradient kernels the same way.

    python3 tools_torch/digit_gemm_variants.py          # from a checkout, one CUDA card
    python3 tools_torch/digit_gemm_variants.py grad_x   # only the named parts

Builds ``stream_conv_grad_w`` and ``stream_conv_fwd`` from copies of their
sources and ``csrc_common/`` (under a temporary directory; the checkout is
not touched), one per variant, and times the digit GEMM alone
(``torch.profiler`` device time, best of two runs of 10 calls):

  * grad_W (``digit_gemm_kernel``) at VGG8B's conv 2 and conv 4 shapes
    (batch 64, int8 x, δ of ±2²⁰: three digit products) and at conv 4 with
    δ of ±100 (one product);
  * the training forward (``conv_digit_gemm_kernel``) at VGG8B's conv 2,
    conv 4 and conv 6 shapes (batch 64, int32 x of the NITRO-ReLU range,
    w of the paper's init range: one product).

Variants:
  * ``base``: the kernel as it is;
  * ``no_mma``: every mma.sync replaced by one xor (copies and ldmatrix
    stay): the time the staging takes alone;
  * ``no_copy``: no cp.async (the MMAs run on whatever shared memory
    holds): the time the fragment loads and MMAs take alone;
  * ``no_copy_B``: only the second operand's copies taken out (δ's planes
    in grad_W, w's in the forward);
  * ``no_store`` (forward only): the epilogue's writes of a and z* taken
    out (the tile is still staged in shared memory);
  * ``ring_3`` (forward only): the ring cut from up to six stages to three;
  * ``divides`` (the matmuls, ``matmul_digit_kernel``): ``nitro::Epilogue``
    (divide instructions) in place of ``FastEpilogue`` — a right result —
    timed at #1's served shapes (int8, batch 32) and #2's VGG8B and mlp4
    shapes (batch 64, x of the NITRO-ReLU range, w of the init's ±4), in
    turns with the kernel as built;
  * the linear grad_W kernels (``grad_w_digit_kernel`` of
    ``nitro_matmul_grad_w`` and ``nitro_matmul_grad_w_opt``) at VGG8B's
    linear and mlp4's 3072 × 3000 layer (batch 64, x in ±127, δ in ±170:
    two products), in turns with the kernel as built: ``plain_store``
    (the stores without the evict-first hint), ``no_store`` (no output
    written), ``no_load`` (x, δ and z* not read: the values come from the
    indices), ``one_block`` (shared memory padded to one block an SM),
    ``no_io`` (neither loads nor stores: the staging arithmetic, MMAs and
    flush alone); for the update ``w_global`` (W read from device memory
    in the flush, no cp.async tile) and ``no_sgd`` (W − g in place of
    IntegerSGD).

  * the input gradients: #10 (``stream_conv_grad_x``: the conv GEMM of
    ``conv_digits.cuh`` on the masked δ's planes) at VGG8B's six conv
    shapes (batch 64, δ of ±2²⁰ and z* over every segment: a masked δ of
    three digits; w of the paper's init range: one) with ``no_mma``,
    ``no_copy``, ``no_copy_B`` (w's planes) and ``no_store`` (grad_x not
    written), the pre-passes' device time beside the GEMM's; #5
    (``nitro_matmul_grad_x``'s ``grad_x_digit_kernel``) at VGG8B's linear
    and mlp4's two layer shapes on the same digits with ``no_mma``,
    ``no_w_copy`` (w's rows not copied: the fragments split whatever
    shared memory holds), ``no_split`` (the fragments take w's low byte
    as its one digit: no byte transposes, one product per δ digit; a
    wrong result) and ``no_store``, in turns with the kernel as built.

The conv and grad_W variants' results are garbage (but those of
``plain_store`` and ``one_block``); only their times are
read.  Prints the
card's name and power limit, each variant's ptxas registers, then one line
per shape.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
MMA = ("digit_gemm.cuh",
       "for (int nt = 0; nt < 4; ++nt) mma_s8(acc[i + j][mt][nt], a[mt], b[j][nt]);",
       "for (int nt = 0; nt < 4; ++nt) acc[i + j][mt][nt][0] ^= a[mt][0] ^ b[j][nt][0];")
LGW_STCS = ("linear_grad_w.cuh",
            "          __stcs(reinterpret_cast<int2*>(dst + idx), make_int2(v0, v1));",
            "          *reinterpret_cast<int2*>(dst + idx) = make_int2(v0, v1);")
LGW_NO_STORE = ("linear_grad_w.cuh",
                "          __stcs(reinterpret_cast<int2*>(dst + idx), make_int2(v0, v1));",
                "          if ((v0 ^ v1) == 0x7fffffff) dst[idx] = v0;")
LGW_NO_LOAD = [("linear_grad_w.cuh", "__ldg(src + (size_t)s * a.M)", "((s ^ r) & 127)"),
               ("linear_grad_w.cuh", "__ldg(a.delta + idx)", "(((int)idx & 255) - 128)"),
               ("linear_grad_w.cuh", "__ldg(a.z + idx)", "(((int)idx & 511) - 256)")]
LGW_ONE_BLOCK = ("linear_grad_w.cuh", "constexpr int SMEM = X_PLANES + G_PLANES;",
                 "constexpr int SMEM = X_PLANES + G_PLANES + 64 * 1024;")
#: per GEMM: library, kernel name, variant → [(file, old, new)]
TARGETS = {
    "grad_w": ("stream_conv_grad_w", "digit_gemm_kernel", {
        "base": [],
        "no_mma": [MMA],
        "no_copy": [("digit_gemm.cuh", "      cp16(as + (i * BM + r) * ROW + 16 * c, src, ok);", ""),
                    ("digit_gemm.cuh", "    cp16(bs + (j * BN + r) * ROW + 16 * c, src, ok);", "")],
        "no_copy_B": [("digit_gemm.cuh",
                       "    cp16(bs + (j * BN + r) * ROW + 16 * c, src, ok);", "")],
    }),
    "fwd": ("stream_conv_fwd", "conv_digit_gemm", {
        "base": [],
        "no_mma": [MMA],
        "no_copy": [
            ("conv_digits.cuh", "      digits::cp16(as + (i * BM + r + 64 * e) * ROW + 16 * c, "
                                "g.xa + i * g.xa_plane + off, ok);", ";"),
            ("conv_digits.cuh", "    digits::cp16(bs + (j * BN + r) * ROW + 16 * c, "
                                "g.wb + j * g.wb_plane + boff, okb);", ";")],
        "no_copy_B": [
            ("conv_digits.cuh", "    digits::cp16(bs + (j * BN + r) * ROW + 16 * c, "
                                "g.wb + j * g.wb_plane + boff, okb);", ";")],
        "no_store": [("stream_conv_fwd.cu",
                      "    write_tile(tile, BM, row0, g.R, g.F, col0, z, [](int v) { return v; });\n"
                      "    write_tile(tile, BM, row0, g.R, g.F, col0, a, "
                      "[&](int v) { return ep.relu(v); });",
                      "    if (tile[threadIdx.x] == 0x7fffffff) z[threadIdx.x] = tile[0];")],
        "ring_3": [("conv_digits.cuh", "(FIT > 6 ? 6 : FIT)", "(FIT > 3 ? 3 : FIT)")],
    }),
    "matmul": ("nitro_matmul", "matmul_digit_kernel", {
        "multiply-highs": [],
        "divides": [
            ("nitro_matmul.cu", "  FastEpilogue ep;", "  Epilogue ep;"),
            ("nitro_matmul.cu", "  const FastEpilogue& ep = o.ep;", "  const Epilogue& ep = o.ep;"),
            ("nitro_matmul.cu", "nitro::FastEpilogue(shift, residual, alpha_inv, mu, apply_relu)",
             "nitro::Epilogue{shift, residual, alpha_inv, mu, apply_relu}"),
            ("nitro_matmul.cu", "nitro::FastEpilogue(shift, residual, alpha_inv, mu, 1)",
             "nitro::Epilogue{shift, residual, alpha_inv, mu, 1}")],
    }),
    "linear": ("nitro_matmul_grad_w", "grad_w_digit_kernel", {
        "base": [],
        "plain_store": [LGW_STCS],
        "no_store": [LGW_NO_STORE],
        "no_load": LGW_NO_LOAD,
        "one_block": [LGW_ONE_BLOCK],
        "no_io": [LGW_NO_STORE, *LGW_NO_LOAD],
    }),
    "linear_opt": ("nitro_matmul_grad_w_opt", "grad_w_digit_kernel", {
        "base": [],
        "plain_store": [LGW_STCS],
        "no_store": [LGW_NO_STORE],
        "no_load": LGW_NO_LOAD,
        "one_block": [LGW_ONE_BLOCK],
        "w_global": [("linear_grad_w.cuh", "    stage_w(a, wt, m0, n0);", ""),
                     ("linear_grad_w.cuh",
                      "          const int32_t* w = wt + (m - m0) * W_ROW + (f - n0);",
                      "          const int32_t* w = a.w + idx;")],
        "no_sgd": [("linear_grad_w.cuh", "v0 = integer_sgd(w[0], v0, sgd);", "v0 = w[0] - v0;"),
                   ("linear_grad_w.cuh", "v1 = integer_sgd(w[1], v1, sgd);", "v1 = w[1] - v1;")],
    }),
}
GX_NO_STORE = ("stream_conv_grad_x.cu",
               "    write_tile(tile, BM, row0, g.R, g.F, col0, out, same);",
               "    if (tile[threadIdx.x] == 0x7fffffff) out[threadIdx.x] = tile[0];")
TARGETS["grad_x_conv"] = ("stream_conv_grad_x", "conv_digit_gemm", {
    "base": [],
    "no_mma": [MMA],
    "no_copy": TARGETS["fwd"][2]["no_copy"],
    "no_copy_B": TARGETS["fwd"][2]["no_copy_B"],
    "no_store": [GX_NO_STORE],
})
TARGETS["grad_x_linear"] = ("nitro_matmul_grad_x", "grad_x_digit_kernel", {
    "base": [],
    "no_mma": [("nitro_matmul_grad_x.cu",
                "for (int t = 0; t < 4; ++t) digits::mma_s8(acc[i + j][t], a[j], b[i][t]);",
                "for (int t = 0; t < 4; ++t) acc[i + j][t][0] ^= a[j][0] ^ b[i][t][0];")],
    "no_w_copy": [
        ("nitro_matmul_grad_x.cu",
         "      digits::cp16(st + r * WROW + 4 * k, ok ? g.w + (size_t)(m0 + r) * g.N + k0 + k "
         ": g.w, ok);", ""),
        ("nitro_matmul_grad_x.cu",
         "      digits::cp4(st + r * WROW + 4 * k, ok ? g.w + (size_t)(m0 + r) * g.N + k0 + k "
         ": g.w, ok);", "")],
    "no_split": [("nitro_matmul_grad_x.cu", "  any |= d0 | d1 | d2 | d3;\n  unsigned pl[4];\n"
                  "  digits::plane_words(d0, d1, d2, d3, pl);",
                  "  any |= 0u;\n  unsigned pl[4] = {(unsigned)v.x, 0u, 0u, 0u};")],
    "no_store": [("nitro_matmul_grad_x.cu",
                  "    if (b < g.B && m < g.M) g.out[(size_t)b * g.M + m] = "
                  "(int)staged[(i / TM) * (TM + 1) + i % TM];",
                  "    if (staged[i] == 0x7fffffffu) g.out[i] = 0;")],
})
#: (M, K, N, int8 operands, kernel): #1's served linear and output layer,
#: #2's VGG8B linear and mlp4's layers (the second twice in a step)
MATMUL_SHAPES = [(32, 2048, 1024, True, "#1"), (32, 1024, 10, True, "#1"),
                 (64, 2048, 1024, False, "#2 VGG8B"), (64, 3072, 3000, False, "#2 mlp4"),
                 (64, 3000, 3000, False, "#2 mlp4")]
GRAD_W_SHAPES = [((64, 32, 32, 128, 256), 2 ** 20), ((64, 16, 16, 256, 512), 2 ** 20),
                 ((64, 16, 16, 256, 512), 100)]
FWD_SHAPES = [(64, 32, 32, 128, 256), (64, 16, 16, 256, 512), (64, 4, 4, 512, 512)]
#: #10 at VGG8B's six convs, batch 64: δ (N, H, W, F) and grad_x's C
GRAD_X_CONV = [((64, 32, 32, 128), 3), ((64, 32, 32, 256), 128), ((64, 16, 16, 256), 256),
               ((64, 16, 16, 512), 256), ((64, 8, 8, 512), 512), ((64, 4, 4, 512), 512)]
#: #5 at VGG8B's linear and mlp4's layers: (B, N, M), δ (B, N) and w (M, N)
GRAD_X_LINEAR = [(64, 1024, 2048), (64, 3000, 3072), (64, 3000, 3000)]


def build(tmp: Path, target: str) -> dict[str, ctypes.CDLL]:
    """One library per variant of ``target``, built in parallel."""
    from repro_torch.kernels import cuda_lib

    lib_name, kernel, variants = TARGETS[target]
    source = cuda_lib.SOURCES[lib_name]
    jobs = []
    for name, edits in variants.items():
        d = tmp / f"{target}_{name}"
        d.mkdir()
        for f in [*(KERNELS / "csrc_common").glob("*.cuh"), source]:
            shutil.copy(f, d / f.name)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if old not in text:
                raise SystemExit(f"variant {target}/{name}: {fname} no longer has {old!r}")
            (d / fname).write_text(text.replace(old, new))
        flags = [str(d) if a == str(KERNELS / "csrc_common") else a for a in cuda_lib.NVCC_FLAGS]
        out = d / "lib.so"
        cmd = [cuda_lib.nvcc_path(), *flags, "-o", str(out), str(d / source.name)]
        jobs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {target}/{name}:\n{log}")
        entry = next((e for e in log.split("Compiling entry function")[1:]
                      if kernel in e.split("\n")[0]), "")
        regs = [line.strip() for line in entry.splitlines() if "registers" in line][:1]
        print(f"[variant] {target}/{name}: {kernel} {regs[0] if regs else ''}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def gemm_ms(call, kernel: str, tries: int = 5) -> float:
    """Best of two profiler sessions of 10 calls, each the mean over the
    launches of ``kernel`` it saw (the profiler drops some now and then);
    a session that saw none is run again, up to ``tries`` sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel in e.key]
        launches = sum(e.count for e in hits)
        if launches:
            times.append(sum(e.self_device_time_total for e in hits) / launches / 1e3)
        if len(times) == 2:
            return min(times)
    raise SystemExit(f"the profiler saw no launch of {kernel} in {tries} sessions")


def bind(lib, name: str, n_ptrs: int, n_ints: int, n_shape: int):
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    nbytes = getattr(lib, f"{name}_scratch_bytes")
    nbytes.argtypes, nbytes.restype = [ctypes.c_int] * n_shape, ctypes.c_longlong
    return launch, nbytes


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("digit_gemm_variants needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    g = torch.Generator().manual_seed(0)

    def ints(shape, lim):
        return torch.randint(-lim, lim, shape, generator=g).to(torch.int32).cuda()

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parts = sys.argv[1:] or ["grad_w", "fwd", "matmul", "linear", "grad_x"]
    with tempfile.TemporaryDirectory() as tmp:
        if "grad_x" in parts:
            grad_x_conv(Path(tmp), ints, sms, stream)
            grad_x_linear(Path(tmp), ints, sms, stream)
        if "grad_w" in parts:
            libs = build(Path(tmp), "grad_w")
            for (n, h, w, c, f), lim in GRAD_W_SHAPES:
                x, d = ints((n, h, w, c), 128), ints((n, h, w, f), lim)
                z = ints((n, h, w, f), 300)
                times = []
                for name, lib in libs.items():
                    launch, nbytes = bind(lib, "stream_conv_grad_w", 5, 8, 6)
                    scratch = torch.empty(nbytes(n, h, w, c, f, 3), dtype=torch.uint8,
                                          device="cuda")
                    out = torch.zeros((9 * c, f), dtype=torch.int32, device="cuda")
                    args = (x.data_ptr(), d.data_ptr(), z.data_ptr(), out.data_ptr(),
                            scratch.data_ptr(), n, h, w, c, f, 3, 10, sms, stream)
                    if launch(*args):
                        raise SystemExit(f"variant {name}: launch failed")
                    times.append(f"{name} {gemm_ms(lambda: launch(*args), 'digit_gemm'):.4f}")
                print(f"[variant] x{(n, h, w, c)} delta +-{lim} F={f}: digit_gemm_kernel ms "
                      + " | ".join(times))
        if "fwd" in parts:
            libs = build(Path(tmp), "fwd")
            for n, h, w, c, f in FWD_SHAPES:
                x, wt = ints((n, h, w, c), 128), ints((3, 3, c, f), 6)
                a = torch.empty((n, h, w, f), dtype=torch.int32, device="cuda")
                z = torch.empty_like(a)
                times = []
                for name, lib in libs.items():
                    launch, nbytes = bind(lib, "stream_conv_fwd", 5, 13, 7)
                    scratch = torch.empty(nbytes(n, h, w, c, f, 3, 0), dtype=torch.uint8,
                                          device="cuda")
                    args = (x.data_ptr(), wt.data_ptr(), a.data_ptr(), z.data_ptr(),
                            scratch.data_ptr(), n, h, w, c, f, 3, 0, 0, 9, 1, 10, 0, sms, stream)
                    if launch(*args):
                        raise SystemExit(f"variant {name}: launch failed")
                    t = gemm_ms(lambda: launch(*args), "conv_digit_gemm")
                    times.append(f"{name} {t:.4f}")
                print(f"[variant] fwd x{(n, h, w, c)} w +-6 F={f}: conv_digit_gemm_kernel ms "
                      + " | ".join(times))
        if "matmul" in parts:
            matmul_epilogues(Path(tmp), ints, sms, stream)
        if "linear" in parts:
            linear_grad_w(Path(tmp), ints, sms, stream)
    return 0


def linear_grad_w(tmp: Path, ints, sms: int, stream: int) -> None:
    """#3 and #4 with each variant, per shape in turns (the order of the
    variants, then reversed; the best of each)."""
    import torch

    for target, opt in (("linear", False), ("linear_opt", True)):
        libs = build(tmp, target)
        for m, n in ((2048, 1024), (3072, 3000)):
            x, d, z, w = ints((64, m), 128), ints((64, n), 171), ints((64, n), 301), \
                ints((m, n), 2 ** 15)
            gamma = torch.tensor(327680, dtype=torch.int32, device="cuda")
            eta = torch.tensor(25000, dtype=torch.int32, device="cuda")
            out = torch.empty((m, n), dtype=torch.int32, device="cuda")
            best = {}
            for name in [*libs, *reversed(libs)]:
                if opt:
                    launch = libs[name].nitro_matmul_grad_w_opt_launch
                    launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                    args = (x.data_ptr(), d.data_ptr(), z.data_ptr(), w.data_ptr(), out.data_ptr(),
                            gamma.data_ptr(), eta.data_ptr(), 64, m, n, 10, sms, stream)
                else:
                    launch = libs[name].nitro_matmul_grad_w_launch
                    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                    args = (x.data_ptr(), d.data_ptr(), z.data_ptr(), out.data_ptr(), 64, m, n,
                            10, sms, stream)
                launch.restype = ctypes.c_int
                if launch(*args):
                    raise SystemExit(f"{target} variant {name}: launch failed")
                t = gemm_ms(lambda: launch(*args), "grad_w_digit_kernel")
                best[name] = min(best.get(name, t), t)
            print(f"[variant] {'#4' if opt else '#3'} (64, {m}) -> {n}: grad_w_digit_kernel ms "
                  + " | ".join(f"{a} {b:.4f}" for a, b in best.items()))


def matmul_epilogues(tmp: Path, ints, sms: int, stream: int) -> None:
    """The matmul GEMM with each epilogue form, per shape in turns (as
    built, divides, divides, as built; the best of each), then summed per
    served batch (#1) and per VGG8B and mlp4 step (#2)."""
    import torch

    libs = build(tmp, "matmul")
    arrivals = torch.zeros(64, dtype=torch.int32, device="cuda")
    totals: dict[tuple[str, str], float] = {}
    for m, k, n, int8, what in MATMUL_SHAPES:
        dt = torch.int8 if int8 else torch.int32
        x, w = ints((m, k), 128).to(dt), ints((k, n), 128 if int8 else 5).to(dt)
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        z = torch.empty_like(out)
        best = {}
        for name in ("multiply-highs", "divides", "divides", "multiply-highs"):
            lib = libs[name]
            nbytes = lib.nitro_matmul_scratch_bytes
            nbytes.argtypes, nbytes.restype = [ctypes.c_int] * 7, ctypes.c_longlong
            scratch = torch.empty(nbytes(m, n, k, int(int8), int(int8), int(int8), sms),
                                  dtype=torch.uint8, device="cuda")
            if int8:  # #1: relu(z*) − μ as int32
                launch = lib.nitro_matmul_launch
                launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
                args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                        arrivals.data_ptr(), m, n, k, 9, 1, 10, 0, 1, 0, 1, 1, 1, sms, stream)
            else:  # #2: (a, z*)
                launch = lib.nitro_matmul_fwd_launch
                launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
                args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), z.data_ptr(),
                        scratch.data_ptr(), arrivals.data_ptr(), m, n, k, 9, 3, 10, 0, 0, 0, 0,
                        sms, stream)
            launch.restype = ctypes.c_int
            if launch(*args):
                raise SystemExit(f"matmul variant {name}: launch failed")
            t = gemm_ms(lambda: launch(*args), "matmul_digit")
            best[name] = min(best.get(name, t), t)
        for name, t in best.items():
            key = (what, name)
            totals[key] = totals.get(key, 0.0) + t * (2 if (m, k, n) == (64, 3000, 3000) else 1)
        print(f"[variant] matmul ({m},{k},{n}) {'int8' if int8 else 'int32'} {what}: "
              f"matmul_digit_kernel ms " + " | ".join(f"{a} {b:.4f}" for a, b in best.items()))
    for what in ("#1", "#2 VGG8B", "#2 mlp4"):
        per = "served batch" if what == "#1" else "step"
        print(f"[fastdiv] {what} per {per}: multiply-highs "
              f"{totals[(what, 'multiply-highs')]:.4f} ms, divides "
              f"{totals[(what, 'divides')]:.4f} ms (GEMM device time, best of two turns)")


def device_split(call, kernel: str) -> tuple[float, float]:
    """(every device operation of one call, ``kernel``'s share), ms, from
    one profiler session of 10 calls that saw every launch of ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        hits = [e for e in events if kernel in e.key]
        if sum(e.count for e in hits) == 10:
            return (sum(e.self_device_time_total for e in events) / 1e4,
                    sum(e.self_device_time_total for e in hits) / 1e4)
    raise SystemExit(f"the profiler missed launches of {kernel} in 5 sessions")


def grad_x_conv(tmp: Path, ints, sms: int, stream: int) -> None:
    """#10 with each variant at VGG8B's six conv shapes, in turns (the
    order of the variants, then reversed; the best of each), and the whole
    call's device time (memset and pre-passes) as built."""
    import torch

    libs = build(tmp, "grad_x_conv")
    totals: dict[str, float] = {}
    for (n, h, w, f), c in GRAD_X_CONV:
        d, z, wt = ints((n, h, w, f), 2 ** 20), ints((n, h, w, f), 301), ints((3, 3, c, f), 6)
        out = torch.empty((n, h, w, c), dtype=torch.int32, device="cuda")
        best, calls = {}, {}
        for name in [*libs, *reversed(libs)]:
            launch, nbytes = bind(libs[name], "stream_conv_grad_x", 5, 8, 6)
            scratch = torch.empty(nbytes(n, h, w, f, c, 3), dtype=torch.uint8, device="cuda")
            args = (d.data_ptr(), z.data_ptr(), wt.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), n, h, w, f, c, 3, 10, sms, stream)
            if launch(*args):
                raise SystemExit(f"grad_x_conv variant {name}: launch failed")
            calls[name] = (launch, args, scratch)
            t = gemm_ms(lambda: launch(*args), "conv_digit_gemm")
            best[name] = min(best.get(name, t), t)
        launch, args, _ = calls["base"]
        total, gemm = device_split(lambda: launch(*args), "conv_digit_gemm")
        totals["call"] = totals.get("call", 0.0) + total
        for name, t in best.items():
            totals[name] = totals.get(name, 0.0) + t
        print(f"[variant] #10 delta{(n, h, w, f)} -> C={c}: call {total:.4f} ms (GEMM "
              f"{gemm:.4f}, pre-passes and memset {total - gemm:.4f}) | conv_digit_gemm_kernel "
              f"ms " + " | ".join(f"{a} {b:.4f}" for a, b in best.items()))
    print("[variant] #10 per pass of the six: " + " | ".join(
        f"{a} {b:.4f}" for a, b in totals.items()) + " ms")


def grad_x_linear(tmp: Path, ints, sms: int, stream: int) -> None:
    """#5 with each variant at VGG8B's linear and mlp4's layers, in turns,
    and the whole call's device time as built."""
    import torch

    libs = build(tmp, "grad_x_linear")
    arrivals = torch.zeros(64, dtype=torch.int32, device="cuda")
    for b, n, m in GRAD_X_LINEAR:
        d, z, w = ints((b, n), 2 ** 20), ints((b, n), 301), ints((m, n), 6)
        out = torch.empty((b, m), dtype=torch.int32, device="cuda")
        best, calls = {}, {}
        for name in [*libs, *reversed(libs)]:
            lib = libs[name]
            launch = lib.nitro_matmul_grad_x_launch
            launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            launch.restype = ctypes.c_int
            nbytes = lib.nitro_matmul_grad_x_scratch_bytes
            nbytes.argtypes, nbytes.restype = [ctypes.c_int] * 4, ctypes.c_longlong
            scratch = torch.empty(nbytes(b, m, n, sms), dtype=torch.uint8, device="cuda")
            args = (d.data_ptr(), z.data_ptr(), w.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    arrivals.data_ptr(), b, m, n, 10, 1, sms, stream)
            if launch(*args):
                raise SystemExit(f"grad_x_linear variant {name}: launch failed")
            calls[name] = (launch, args, scratch)
            t = gemm_ms(lambda: launch(*args), "grad_x_digit_kernel")
            best[name] = min(best.get(name, t), t)
        launch, args, _ = calls["base"]
        total, gemm = device_split(lambda: launch(*args), "grad_x_digit_kernel")
        print(f"[variant] #5 delta({b}, {n}) w({m}, {n}): call {total:.4f} ms (GEMM {gemm:.4f}, "
              f"pre-pass and memset {total - gemm:.4f}) | grad_x_digit_kernel ms "
              + " | ".join(f"{a} {b:.4f}" for a, b in best.items()))


if __name__ == "__main__":
    sys.exit(main())
