#!/usr/bin/env python3
"""Compare the full-width VGG8B training step, the served VGG8B batch, the
full-width mlp4 training step (split and ``fuse_opt``) and the linear
grad_W kernels of two checkouts of the port on one CUDA card, in turns
(A, B, B, A), each turn in a fresh process.

    git archive PARENT | tar -x -C .chip_checkout/parent   # a git-ignored dir
    python3 tools_torch/step_ab.py .chip_checkout/parent .

For each turn it builds the kernels those paths run (from that tree's
sources), then prints one ``[ab]`` line: the split step's and the
``fuse_opt`` step's host-to-host time at batch 64 (best of three turns of
10 steps, ``torch.cuda.synchronize`` at the end) and their device busy
time per step from ``torch.profiler`` over 3 steps (the idle share is of
that profiled window, whose host time the profiler lengthens); the same
for a batch of 32 through the served plan (``ExecutionPlan.logits``, the
seeded init, logits back on the host) and for the mlp4 steps at batch 64.
Then one ``[ab-kernels]`` line: the device time of one call of
``nitro_matmul_grad_w`` (#3) and ``nitro_matmul_grad_w_opt`` (#4) at
VGG8B's linear (64 × 2048 → 1024) and mlp4's two layer shapes, every
device operation of the call summed (the parent's #3 zero-fills its
output first), from ``torch.profiler`` over 20 calls, on operands of the
main path's digits (x in ±127: one digit; δ in ±170 with z* over every
NITRO-ReLU segment: two).  Then one ``[ab-grad-x]`` line: the device time
of one grad_x pass of ``stream_conv_grad_x`` (#10) over VGG8B's six conv
shapes at batch 64 and of one ``nitro_matmul_grad_x`` (#5) call at VGG8B's
linear and mlp4's two layer shapes, every device operation summed, from
``torch.profiler`` over 5 passes (20 calls for #5), on the operands
``chip_smoke.py`` times them on (δ in ±2²⁰ with z* over every segment: a
masked δ of three digits; w in ±2¹⁵: three).  Then one ``[ab-sgd]`` line:
one fused apply (``les.apply_gradients(fuse_opt=True)``, every weight
tensor through ``integer_sgd_update``, #11) on VGG8B's and mlp4's trees,
from the step's own gradients: its device time (every device operation,
``torch.profiler`` over 20 applies) and its host-to-host time (best of
three runs of 20, ``torch.cuda.synchronize`` at the end); and the device
time of one ``fuse_opt`` step's six ``stream_conv_grad_w_opt`` calls (#9)
at VGG8B's conv shapes, every device operation summed, on the operands
``chip_smoke.py`` times it on (x in ±127, δ in ±2²⁰, z* over every
segment).  The card's name and power limit come first.  Needs one card;
no network.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

TRAIN_LIBS = ["stream_conv", "stream_conv_fwd", "nitro_matmul", "stream_conv_grad_w",
              "stream_conv_grad_w_opt", "nitro_matmul_grad_w", "nitro_matmul_grad_w_opt",
              "stream_conv_grad_x", "nitro_matmul_grad_x", "integer_sgd"]
#: #10's six VGG8B shapes at batch 64: δ (N, H, W, F), grad_x's C
GRAD_X_CONVS = [((64, 32, 32, 128), 3), ((64, 32, 32, 256), 128), ((64, 16, 16, 256), 256),
                ((64, 16, 16, 512), 256), ((64, 8, 8, 512), 512), ((64, 4, 4, 512), 512)]


def turn(root: str) -> None:
    """One tree's measurement, in this process."""
    sys.path.insert(0, str(Path(root) / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_paper_config
    from repro_torch.core import les, prng
    from repro_torch.core import model as M
    from repro_torch.infer import compile_plan, freeze
    from repro_torch.kernels import cuda_lib

    if Path(root).resolve() not in Path(cuda_lib.__file__).resolve().parents:
        raise SystemExit(f"imported {cuda_lib.__file__}, not the tree at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("step_ab needs a CUDA card")
    cuda_lib.build_all(TRAIN_LIBS)
    cfg = get_paper_config("vgg8b", scale=1.0)
    state = les.create_train_state(prng.PRNGKey(0), cfg, device="cuda")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-127, 128, (64, *cfg.input_shape))
                         .astype(np.int32)).cuda()
    y = torch.from_numpy(rng.integers(0, 10, 64).astype(np.int32)).cuda()
    key = prng.PRNGKey(4)
    plan = compile_plan(freeze(M.init_params(prng.PRNGKey(0), cfg, device="cpu"), cfg),
                        device="cuda")
    batch = rng.integers(-127, 128, (32, *cfg.input_shape)).astype(np.int32)
    mcfg = get_paper_config("mlp4", scale=1.0)
    mstate = les.create_train_state(prng.PRNGKey(0), mcfg, device="cuda")
    mx = torch.from_numpy(rng.integers(-127, 128, (64, *mcfg.input_shape))
                          .astype(np.int32)).cuda()
    steps = {"split": lambda: les.train_step(state, cfg, x, y, key),
             "fuse_opt": lambda: les.train_step(state, cfg, x, y, key, fuse_opt=True),
             "served batch": lambda: plan.logits(batch).cpu(),
             "mlp4": lambda: les.train_step(mstate, mcfg, mx, y, key),
             "mlp4 fuse_opt": lambda: les.train_step(mstate, mcfg, mx, y, key, fuse_opt=True)}

    def host_ms(fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    ms: dict[str, float] = {}
    order = list(steps)
    for name in order + order[::-1] + order:
        t = host_ms(steps[name])
        ms[name] = min(ms.get(name, t), t)
    parts = []
    for name in order:
        steps[name]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                steps[name]()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.self_device_time_total > 0) / 1e3
        n = 32 if name == "served batch" else 64
        parts.append(f"{name}: host to host {ms[name]:.3f} ms ({n * 1e3 / ms[name]:.1f} img/s), "
                     f"device busy {busy / 3:.3f} ms/call, idle {100 - 100 * busy / wall:.1f}% "
                     f"of the profiled 3 calls")
    print(f"[ab] {root}: " + " | ".join(parts), flush=True)
    print(f"[ab-kernels] {root}: " + " | ".join(grad_w_kernel_ms(torch, profile,
                                                                   ProfilerActivity)),
          flush=True)
    print(f"[ab-grad-x] {root}: " + " | ".join(grad_x_kernel_ms(torch, profile,
                                                                 ProfilerActivity)),
          flush=True)
    trees = {"VGG8B": (state, cfg, x), "mlp4": (mstate, mcfg, mx)}
    print(f"[ab-sgd] {root}: " + " | ".join(sgd_ms(torch, profile, ProfilerActivity, trees,
                                                   y, key)), flush=True)


def device_ms_per(torch, profile, activity, fn, calls: int, kernel: tuple, launches: int):
    """Device ms of one ``fn()``: every device operation over ``calls``
    calls, from a profiler session that saw ``launches`` launches whose
    name holds one of ``kernel`` (one that missed some runs again)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[activity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if sum(e.count for e in events if any(k in e.key for k in kernel)) == launches:
            return sum(e.self_device_time_total for e in events
                       if e.self_device_time_total > 0) / 1e3 / calls
    raise SystemExit(f"the profiler missed launches of {kernel}")


def sgd_ms(torch, profile, activity, trees: dict, y, key) -> list[str]:
    """Device and host-to-host ms of one fused apply per tree, and the
    device ms of #9 over VGG8B's six conv shapes."""
    from repro_torch.core import les
    from repro_torch.core import optimizer as opt
    from repro_torch.kernels.integer_sgd import integer_sgd_update
    from repro_torch.kernels.nitro_conv.ops import conv_grad_w_opt

    parts = []
    for tag, (state, cfg, x) in trees.items():
        grads, _, _ = les.compute_gradients(state, cfg, x, y, key)

        def apply():
            return les.apply_gradients(state, grads, fuse_opt=True)

        integer_sgd_update.launches.reset()
        apply()
        per = integer_sgd_update.launches.value  # launches of #11 per apply
        device = device_ms_per(torch, profile, activity, apply, 20, ("integer_sgd",), 20 * per)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                apply()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3 / 20)
        parts.append(f"#11 {tag} fused apply ({per} launch{'es' if per > 1 else ''}) device "
                     f"{device:.4f} ms, host to host {min(host):.4f} ms")
    g = torch.Generator().manual_seed(2)

    def ints(shape, lim):
        return torch.randint(-lim, lim + 1, shape, generator=g).to(torch.int32).cuda()

    sgd = opt.init_state(327680, 25000, device="cuda")
    convs = [(ints((*d[:3], c), 127), ints(d, 2 ** 20), ints(d, 300),
              ints((3, 3, c, d[-1]), 2 ** 15)) for d, c in GRAD_X_CONVS]

    def opt_pass():
        for xc, delta, z, w in convs:
            conv_grad_w_opt(xc, delta, w, sgd.gamma_inv, sgd.eta_inv, kernel_size=3,
                            z_star=z, backend="cuda")

    ms = device_ms_per(torch, profile, activity, opt_pass, 5, ("digit_gemm",), 30)
    parts.append(f"#9 VGG8B fuse_opt step's six {ms:.4f} ms")
    return parts


def grad_x_kernel_ms(torch, profile, activity) -> list[str]:
    """Device ms of one #10 pass over VGG8B's convs and of one #5 call at
    each main-path linear shape."""
    from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv_grad_x
    from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul_grad_x

    g = torch.Generator().manual_seed(1)

    def ints(shape, lim):
        return torch.randint(-lim, lim + 1, shape, generator=g).to(torch.int32).cuda()

    convs = [(ints(d, 2 ** 20), ints(d, 300), ints((3, 3, c, d[-1]), 2 ** 15))
             for d, c in GRAD_X_CONVS]

    def conv_pass():
        for delta, z, w in convs:
            stream_conv_grad_x(delta, z, w)

    # #10's GEMM, once a call: the parent's kernel, or the digit GEMM's
    # epilogue type
    gemm = ("stream_conv_grad_x_kernel", "GradXOut")
    parts = [f"#10 VGG8B pass of six "
             f"{device_ms_per(torch, profile, activity, conv_pass, 5, gemm, 30):.4f} ms"]
    for tag, (b, m, n) in (("VGG8B", (64, 2048, 1024)), ("mlp4 3072x3000", (64, 3072, 3000)),
                           ("mlp4 3000x3000", (64, 3000, 3000))):
        delta, z, w = ints((b, n), 2 ** 20), ints((b, n), 300), ints((m, n), 2 ** 15)
        ms = device_ms_per(torch, profile, activity, lambda: nitro_matmul_grad_x(delta, z, w),
                           20, ("grad_x",), 20)
        parts.append(f"#5 {tag} {ms:.4f} ms")
    return parts


def grad_w_kernel_ms(torch, profile, activity) -> list[str]:
    """Device ms of one #3 and one #4 call at each main-path linear shape."""
    from repro_torch.kernels.nitro_matmul.nitro_matmul import (
        nitro_matmul_grad_w, nitro_matmul_grad_w_opt)

    g = torch.Generator().manual_seed(0)

    def ints(shape, lim):
        return torch.randint(-lim, lim + 1, shape, generator=g).to(torch.int32).cuda()

    parts = []
    for tag, (b, m, n) in (("VGG8B", (64, 2048, 1024)), ("mlp4 3072x3000", (64, 3072, 3000)),
                           ("mlp4 3000x3000", (64, 3000, 3000))):
        x, delta, z, w = ints((b, m), 127), ints((b, n), 170), ints((b, n), 300), \
            ints((m, n), 2 ** 15)
        gamma, eta = torch.tensor(327680, dtype=torch.int32).cuda(), \
            torch.tensor(25000, dtype=torch.int32).cuda()
        for name, fn in (("#3", lambda: nitro_matmul_grad_w(x, delta, z)),
                         ("#4", lambda: nitro_matmul_grad_w_opt(x, delta, z, w, gamma, eta))):
            fn()
            torch.cuda.synchronize()
            for _ in range(5):  # a session that missed a launch runs again
                with profile(activities=[activity.CUDA]) as prof:
                    for _ in range(20):
                        fn()
                    torch.cuda.synchronize()
                events = prof.key_averages()
                if sum(e.count for e in events if "grad_w" in e.key) == 20:
                    break
            else:
                raise SystemExit(f"the profiler missed launches of {name} at {tag}")
            busy = sum(e.self_device_time_total for e in events
                       if e.self_device_time_total > 0) / 1e3
            parts.append(f"{name} {tag} {busy / 20:.4f} ms")
    return parts


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--turn":
        turn(argv[2])
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    a, b = argv[1], argv[2]
    for root in (a, b, b, a):
        subprocess.run([sys.executable, __file__, "--turn", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
