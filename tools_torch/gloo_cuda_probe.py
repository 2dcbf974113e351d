#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors as they are.

    PYTHONPATH=src python3 tools_torch/gloo_cuda_probe.py   # one CUDA card

``parallel.collectives`` copies a CUDA tensor to the host before every
gloo collective.  This script finds out whether that copy is needed: for
each collective the data-parallel step uses (all_reduce SUM, MIN and MAX
on int32, and the ring's ``batch_isend_irecv``) it spawns two gloo ranks
on card 0 and calls the collective on CUDA tensors directly, each kind in
a process group of its own, under a time limit.  One line per kind: the
result is exact, wrong, an exception (its first line), or the ranks died
or hung.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("all_reduce_sum", "all_reduce_min", "all_reduce_max", "batch_isend_irecv")


def probe(axis, device, kind: str) -> str:
    """Rank body: the collective on CUDA int32 tensors; returns a verdict."""
    import torch
    import torch.distributed as dist

    r, n = axis.rank, axis.size
    x = torch.arange(5, dtype=torch.int32, device=device) + 10 * r
    try:
        if kind.startswith("all_reduce"):
            op = kind.rsplit("_", 1)[1]
            dist.all_reduce(x, op=getattr(dist.ReduceOp, op.upper()))
            want = {"sum": 10 * sum(range(n)), "min": 0, "max": 10 * (n - 1)}[op]
            ok = torch.equal(x.cpu(), torch.arange(5, dtype=torch.int32) * (n if op == "sum" else 1)
                             + want)
        else:
            recv = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, (r + 1) % n), dist.P2POp(dist.irecv, recv, (r - 1) % n)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            ok = torch.equal(recv.cpu(), torch.arange(5, dtype=torch.int32) + 10 * ((r - 1) % n))
        return "accepted, exact" if ok else "accepted, WRONG result"
    except Exception as e:  # the verdict is the exception: report it, do not fail
        return f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"


def main() -> int:
    if len(sys.argv) == 2:  # one kind, in a process group of its own
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.parallel import dp

        verdicts = dp.spawn(probe, 2, device="cuda", cards=1, args=(sys.argv[1],))
        print(" | ".join(f"rank {r}: {v}" for r, v in enumerate(verdicts)))
        return 0
    import torch

    print(f"[gloo-cuda] torch {torch.__version__}, {torch.cuda.get_device_name(0)}, "
          f"2 gloo ranks on cuda:0")
    for kind in KINDS:
        proc = subprocess.Popen([sys.executable, __file__, kind], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=180)
            verdict = (out.strip().splitlines() or ["no output"])[-1]
            if proc.returncode:
                verdict = f"ranks failed (exit {proc.returncode}): {verdict[:200]}"
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            verdict = "hung for 180 s (killed)"
        print(f"[gloo-cuda] {kind}: {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
