"""The benchmark of the PyTorch/CUDA port of NITRO-D.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card(s) of this machine and
prints one JSON object as the last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, a device breakdown and the device's busy time.  Every
run compares what its timed path produced with the plain reference under
``perfbench/reference/`` and prints each number compared beside its limit.
It exits without a result when the cell's cards are missing, and when the
JAX stack or the JAX package has been loaded, in this process or in a
rank it started.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench import context, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.resolve(args.workload)
    harness.require_cards(cell.chips)
    import torch

    torch.set_num_threads(2)
    harness.stage("torch imported, cards found", T_START)
    from repro_torch.kernels import cuda_lib

    cuda_lib.build_all()
    harness.stage("kernel libraries built or found", T_START)
    ctx = context.Context.for_cell(cell, seed=args.seed, seconds=args.seconds,
                                   trace=bool(args.trace), device=torch.device("cuda", 0),
                                   t_start=T_START)
    out = harness.driver(cell.traffic["kind"]).run(ctx)
    return harness.finish(cell, out, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
