"""Collectives over the ranks of a ``parallel.dp.DataAxis`` (port of
``repro.parallel.collectives``), on ``torch.distributed``.

``all_reduce`` is the library's all-reduce (gloo or NCCL); the ring is
scheduled by hand from point-to-point sends (``dist.batch_isend_irecv``),
N − 1 steps each way:

  * ``ring_reduce_scatter`` — rank *r* ends holding reduced chunk *r*;
  * ``ring_all_gather``     — concatenates on dim 0 in rank order;
  * ``ring_all_reduce``     — the two, 2·(N−1)/N of the bytes on the wire
    per rank (bandwidth-optimal); dim 0 is zero-padded to a multiple of N.

For NITRO-D the payloads are int32 gradients: integer addition is
associative, so the ring gives the same bits as ``all_reduce`` at any rank
count.  int32 sums wrap mod 2³², as XLA's do.

gloo's all-reduce takes CUDA tensors (SUM, MIN and MAX on int32, exact),
but its point-to-point sends take host tensors only: a CUDA tensor's
``batch_isend_irecv`` fails in ``writev`` with "Bad address"
(``tools_torch/gloo_cuda_probe.py`` on an H100).  So under gloo the ring
copies a CUDA tensor to the host once (``_wire``), runs there, and copies
the result back; ``all_reduce`` hands gloo the CUDA tensor.  NCCL takes
CUDA tensors for both.  With one rank every collective returns ``x`` as
it is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def axis_size(axis) -> int:
    """The number of ranks on ``axis``."""
    return axis.size


def _wire(x: torch.Tensor, axis) -> torch.Tensor:
    """A contiguous copy of ``x`` that point-to-point sends take: on the
    host for a CUDA tensor under gloo, else on ``x``'s device (the ring
    writes its buffer in place)."""
    if axis.backend == "gloo" and x.is_cuda:
        return x.to("cpu", memory_format=torch.contiguous_format)
    return x.clone(memory_format=torch.contiguous_format)


def all_reduce(x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """``op`` (``sum``, ``min`` or ``max``) of ``x`` over the ranks, on
    ``x``'s device; ``x`` itself is not written."""
    if axis.size == 1:
        return x
    buf = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=_OPS[op], group=axis.group)
    return buf


def _exchange(send: torch.Tensor, axis) -> torch.Tensor:
    """Send ``send`` one hop down the ring (rank r → r+1) and return what
    rank r−1 sent."""
    r, n = axis.rank, axis.size
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (r + 1) % n, axis.group),
           dist.P2POp(dist.irecv, recv, (r - 1) % n, axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _reduce_scatter(x: torch.Tensor, axis) -> torch.Tensor:
    """The ring's first half on a wire tensor whose dim 0 divides by N.

    At step *i* rank *r* forwards slot ``r−1−i`` (which holds ``i+1``
    contributions) and adds the incoming piece into slot ``r−2−i``; after
    N−1 steps slot *r* is the last one written and holds all N.
    """
    r, n = axis.rank, axis.size
    acc = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    for i in range(n - 1):
        piece = _exchange(acc[(r - 1 - i) % n].contiguous(), axis)
        acc[(r - 2 - i) % n] += piece
    return acc[r]


def _all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    r, n = axis.rank, axis.size
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    out[r] = x
    piece = x.contiguous()
    for i in range(n - 1):
        piece = _exchange(piece, axis)
        out[(r - i - 1) % n] = piece
    return out.reshape(n * x.shape[0], *x.shape[1:])


def ring_reduce_scatter(x: torch.Tensor, axis) -> torch.Tensor:
    """Reduce-scatter over an (N−1)-step ring.

    ``x``: the same shape on every rank, dim 0 divisible by N.  Returns this
    rank's reduced chunk (dim 0 / N rows): rank *r* holds Σ over ranks of
    everyone's *r*-th chunk.
    """
    n = axis.size
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(
            f"ring_reduce_scatter: leading dim {x.shape[0]} not divisible "
            f"by ring size {n}; pad first (ring_all_reduce does)")
    return _reduce_scatter(_wire(x, axis), axis).to(x.device)


def ring_all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """All-gather over an (N−1)-step ring; rank r's tensor occupies rows
    ``[r·len, (r+1)·len)`` of the result."""
    if axis.size == 1:
        return x
    return _all_gather(_wire(x, axis), axis).to(x.device)


def ring_all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce (reduce-scatter + all-gather).

    Pads dim 0 with zero rows up to a multiple of N (additively inert), so
    any shape reduces; bitwise ``all_reduce``'s sum for integer dtypes.
    """
    n = axis.size
    if n == 1:
        return x
    wire = _wire(x, axis)
    pad = (-x.shape[0]) % n
    if pad:
        wire = torch.cat([wire, wire.new_zeros((pad, *x.shape[1:]))])
    full = _all_gather(_reduce_scatter(wire, axis), axis)
    return full[:x.shape[0]].to(x.device)
