"""Pipeline-parallel scaffolding (port of ``repro.parallel.pipeline``) —
*not* wired into NITRO-D training, in the JAX package either.

NITRO-D has no inter-block gradient flow, so its natural model
parallelism is block-per-device LES, not pipelining, and the paper-scale
CNNs fit one device; data parallelism is the wired path
(``parallel.dp``).  This module keeps the GPipe-style schedule: a loop
over microbatches, and over a ``torch.distributed`` group a tick schedule
whose activations move one hop around the ring of ranks a tick.

``pipeline_apply`` with no ``axis`` is the sequential reference schedule;
with an ``axis`` (a ``parallel.dp.DataAxis``: the group, this rank, the
number of ranks) each rank runs the tick schedule of the JAX package's
stage-axis path.  The bubble is (S−1)/(M+S−1).

Two flaws of the reference are kept on purpose (ROADMAP, "Flaws of the
reference"): every rank applies ``stage_fn(0, ·)`` (the caller's
``stage_fn`` would have to pick its stage's weights itself), and the
output is reshaped to the input's trailing dims, so stages must preserve
the shape.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel.collectives import _exchange, _wire


def split_microbatches(batch: torch.Tensor, num_micro: int) -> torch.Tensor:
    """(B, ...) → (M, B/M, ...)."""
    b = batch.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} does not split into {num_micro} microbatches")
    return batch.reshape(num_micro, b // num_micro, *batch.shape[1:])


def _ppermute(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` one hop down the ring (rank r → r+1): what rank r−1 sent."""
    if axis.size == 1:
        return x
    return _exchange(_wire(x, axis), axis).to(x.device)


def pipeline_apply(stage_fn: Callable[[int, torch.Tensor], torch.Tensor], x: torch.Tensor,
                   *, num_stages: int, num_micro: int, axis=None) -> torch.Tensor:
    """Run ``num_stages`` sequential stage applications over microbatches.

    stage_fn(stage_idx, micro) → micro'.  Without ``axis`` this is the
    sequential reference schedule: each microbatch through every stage in
    turn.  With ``axis`` each rank runs M + S − 1 ticks: rank 0 feeds a new
    microbatch while any remain, every rank applies its stage and sends the
    result one hop down the ring, and the last rank keeps what leaves it.
    """
    micros = split_microbatches(x, num_micro)

    if axis is None:
        outs = []
        for micro in micros:
            for s in range(num_stages):
                micro = stage_fn(s, micro)
            outs.append(micro)
        return torch.stack(outs).reshape(x.shape[0], *micros.shape[2:])

    stage, n = axis.rank, axis.size
    m = micros.shape[0]
    buf = torch.zeros_like(micros[0])
    outs = torch.zeros_like(micros)
    for t in range(m + n - 1):
        feed = micros[min(t, m - 1)] if stage == 0 and t < m else buf
        worked = stage_fn(0, feed)  # every rank stage 0, as the reference
        out_t = t - (n - 1)
        if stage == n - 1 and 0 <= out_t < m:
            outs[out_t] = worked
        buf = _ppermute(worked, axis)
    return outs.reshape(x.shape[0], *micros.shape[2:])


def bubble_fraction(num_stages: int, num_micro: int) -> float:
    """GPipe bubble: (S−1) / (M + S − 1)."""
    return (num_stages - 1) / (num_micro + num_stages - 1)
