"""What a cost counter cannot read from the dispatcher, told to it here.

A counter (``launch/op_analysis.OpAnalyzer``) registers itself with
``push`` / ``pop`` while it is active.  Two things reach it only through
this module:

  * a hand-written kernel's call (``numerics.int_matmul`` on the card), as
    one product: ``opaque_product`` pauses every active counter around the
    wrapper, so the aten ops inside it (output allocation, memset) are not
    counted, and then records the product with each;
  * which tensors of a step are its gradients (``gradients``): the dry run
    (``launch/dryrun.py``) sizes one chip's share of them by their
    parameter's placement.

With no counter active every function is one test of an empty list.  The
registry is process-wide, not per thread, so the autograd engine's worker
threads (the backward, remat's recompute) report to the same counters.
"""

from __future__ import annotations

from contextlib import ExitStack

_recorders: list = []


def push(recorder) -> None:
    _recorders.append(recorder)


def pop(recorder) -> None:
    if not _recorders or _recorders[-1] is not recorder:
        raise RuntimeError("cost counters must be left in the order they were entered")
    _recorders.pop()


def opaque_product(name: str, fn, a, b):
    """``fn()``, a hand-written kernel's call computing ``a @ b``, counted
    by every active counter as one product and its wrapper's ops not at
    all."""
    if not _recorders:
        return fn()
    active = list(_recorders)
    with ExitStack() as paused:
        for r in active:
            paused.enter_context(r.paused())
        out = fn()
    for r in active:
        r.record_product(name, a, b, out)
    return out


def gradients(tensors) -> None:
    """Tell every active counter that ``tensors`` (a list, one a
    parameter leaf in the parameters' leaf order) are the step's
    gradients."""
    for r in _recorders:
        r.mark_gradients(tensors)
