#!/usr/bin/env python3
"""Phase 7c of ``chip_smoke.py`` on a host with several cards.

    python3 tools_torch/dp_nccl.py        # from the root of a checkout

Builds the kernels, runs phase 5 (4 full-width VGG8B steps on one card,
the reference for every rank) and 5b (the same under ``--fuse-opt``),
then spawns 2 ranks over NCCL, one card each, and, where the host has
four cards, 4 ranks: every arm of ``chip_smoke.DP_ARMS`` on every rank
bitwise phase 5's run, phase 5's launches per rank step, INT32_MAX + 1
wrapping through every reducer, and the ``[dp]`` timing line of each.
Needs two cards; exits non-zero without them or on any mismatch.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        cs.die(f"NCCL needs two CUDA cards; this host has "
               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    card = cs.toolchain(torch)
    cs.build()
    split, _, _ = cs.train_path()
    fuse, _ = cs.fuse_opt_path(split)
    for ranks in (2, 4):
        if torch.cuda.device_count() >= ranks:
            cs.dp_nccl_path(split, fuse, card, ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
