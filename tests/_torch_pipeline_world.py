"""Ranks of the port's pipeline test (``tests/test_torch_dryrun.py``).

    PYTHONPATH=src python tests/_torch_pipeline_world.py --ranks 3 --out /tmp/p3.npy

Starts ``--ranks`` gloo ranks on the CPU through the port's launcher
(``repro_torch.parallel.dp.spawn``).  Each rank runs the stage path of
``parallel.pipeline.pipeline_apply`` on the same int32 input the JAX
package's ``vmap`` test uses (``arange(6 n).reshape(3 n, 2)``, stage
``m * 2``, 3 microbatches) and returns what it holds at the end; the
script saves the ranks' outputs stacked, rank by rank.
"""

from __future__ import annotations

import argparse

import numpy as np


def rank(axis, device):
    import torch

    from repro_torch.parallel.pipeline import pipeline_apply

    n = axis.size
    x = torch.arange(6 * n, dtype=torch.int32, device=device).reshape(3 * n, 2)
    out = pipeline_apply(lambda s, m: m * 2, x, num_stages=n, num_micro=3, axis=axis)
    return out.cpu().numpy()


def main() -> None:
    from repro_torch.parallel import dp

    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    np.save(args.out, np.stack(dp.spawn(rank, args.ranks, device="cpu")))


if __name__ == "__main__":
    main()
