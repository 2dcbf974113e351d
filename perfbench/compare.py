"""The numbers that decide ``correct``, worked out from the program's
outputs and the plain reference's.

NITRO-D computes in integers only, so a sound run equals the reference bit
for bit: every number here reads 0 on a sound run and each limit is 0.
"""

from __future__ import annotations

import statistics

import torch

from perfbench.harness import leaves

LIMIT = 0
#: Leaves whose reference update is under this share of the median leaf's
#: are left out of the norm gaps (their change is rounding alone).
SMALL_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(t.to(torch.float64).norm())


def unequal(a, b) -> int:
    """Values of two tensor trees (or tensors) that differ, bit for bit."""
    n = 0
    for (pa, x), (pb, y) in zip(leaves(a), leaves(b), strict=True):
        if pa != pb or x.shape != y.shape:
            raise ValueError(f"trees differ in structure at {pa} / {pb}")
        n += int((x.to(torch.int64) != y.to(torch.int64).to(x.device)).sum())
    return n


def norm_gap(prog_from, prog_to, ref_from, ref_to) -> float:
    """The worst leaf's gap between the program's and the reference's norm
    of the change ``to − from``, over the larger of that leaf's reference
    norm and the median leaf's."""
    p = [_norm(b.to(torch.int64) - a.to(torch.int64))
         for (_, a), (_, b) in zip(leaves(prog_from), leaves(prog_to), strict=True)]
    r = [_norm(b.to(torch.int64) - a.to(torch.int64))
         for (_, a), (_, b) in zip(leaves(ref_from), leaves(ref_to), strict=True)]
    med = statistics.median(r)
    if med == 0:
        return 0.0 if max(p) == 0 else float("inf")
    return max(abs(pn - rn) / max(rn, med) for pn, rn in zip(p, r) if rn >= SMALL_LEAF * med)


def training_checks(w0, prog_w, prog_metrics, prog_opt, ref_w, ref_metrics, ref_opt) -> dict:
    """The training cells' numbers, each with its limit.

    ``prog_w`` / ``ref_w``: the weights after steps 1 and 3 (host trees);
    ``*_metrics``: each step's (loss, correct, local_losses);
    ``*_opt``: the optimiser scalars and step counter after step 3.
    """
    loss = max(abs(int(p[0]) - int(r[0])) / max(abs(int(r[0])), 1)
               for p, r in zip(prog_metrics, ref_metrics, strict=True))
    return {
        "loss": (loss, LIMIT),
        "update1": (norm_gap(w0, prog_w[0], w0, ref_w[0]), LIMIT),
        "change3": (norm_gap(w0, prog_w[1], w0, ref_w[1]), LIMIT),
        "unequal": (unequal(prog_w, ref_w) + unequal(list(prog_metrics), list(ref_metrics))
                    + unequal(prog_opt, ref_opt), LIMIT),
    }
