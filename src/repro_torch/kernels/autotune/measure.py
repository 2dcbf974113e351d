"""Contention-robust kernel timing: the ABBA min-of-N paired harness (port
of ``repro.kernels.autotune.measure``), shared by the autotuner and the
on-card timing scripts.

On a CUDA device each call is timed with a pair of ``torch.cuda.Event``\\ s
and a ``synchronize``; on the CPU with ``time.perf_counter``.  The device
is ``device=`` when given, else that of the first tensor among the
arguments, else the CPU.

Cold or warm L2: on the card each timed call first overwrites a 64 MiB
buffer (more than the H100's 50 MB L2), outside the events, so every
variant meets its operands cold, as a training step or a served batch
does: between two launches of one kernel, the other layers' work has
streamed far more than 50 MB through the cache.  Every variant is still
run once before the first round (warm-up: the kernel library loaded, the
allocator's blocks cached).

Device time, not host time: after the flush the stream spins for about
half a millisecond (``torch.cuda._sleep``) before the start event, so the
wrapper's host path is queued behind the spin and the events bracket only
the call's device work (its memset, pre-passes and GEMM), even for a
kernel shorter than its wrapper's host path.
"""

from __future__ import annotations

import time

import torch

#: Bytes written between timed calls on the card: more than its 50 MB L2.
FLUSH_BYTES = 64 * 1024 * 1024
#: Clock cycles the stream spins before a timed call (about 0.5 ms at an
#: H100's 1.98 GHz): longer than a wrapper's host path.
SPIN_CYCLES = 1_000_000
_flush: dict[torch.device, torch.Tensor] = {}


def _device(args, kw, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    for a in (*args, *kw.values()):
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _timer(device: torch.device):
    """A function ``f ↦ seconds`` that times one call of ``f()``."""
    if device.type != "cuda":
        def cpu(f):
            t0 = time.perf_counter()
            f()
            return time.perf_counter() - t0
        return cpu
    buf = _flush.get(device)
    if buf is None:
        buf = _flush[device] = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin = getattr(torch.cuda, "_sleep", None)

    def cuda(f):
        buf.zero_()  # evict the operands from L2
        if spin is not None:
            spin(SPIN_CYCLES)  # the call's launches queue up behind it
        start.record()
        f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return cuda


def time_fn(fn, *args, iters: int = 10, warmup: int = 2, device=None, **kw) -> float:
    """Median time per call of ``fn(*args, **kw)`` in microseconds."""
    dev = _device(args, kw, device)
    for _ in range(warmup):
        fn(*args, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timer = _timer(dev)
    times = sorted(timer(lambda: fn(*args, **kw)) for _ in range(iters))
    return times[len(times) // 2] * 1e6


def time_paired(fns: dict, *args, iters: int, device=None, **kw) -> dict:
    """Interleaved min-of-N per variant, in microseconds.

    Every round times each variant once, back to back, the order reversed
    every other round (ABBA), so drift between rounds cannot pass for a
    difference between variants; the minimum over rounds bounds each
    variant's own cost, as interference only ever adds to a sample.
    Every variant is run once before the first round.
    """
    dev = _device(args, kw, device)
    for fn in fns.values():
        fn(*args, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timer = _timer(dev)
    names = list(fns)
    best = {m: float("inf") for m in names}
    for i in range(iters):
        for m in names if i % 2 == 0 else reversed(names):
            best[m] = min(best[m], timer(lambda: fns[m](*args, **kw)) * 1e6)
    return best
