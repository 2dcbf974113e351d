"""Dispatch layer (``kernels/*/ops.py``, ``kernels/grad_ops.py``,
``cuda_lib.py``): host milliseconds in a ``train_step`` call (the
benchmark's ``train_step`` span; rank 0's under data parallelism), averaged
over a few steps of the traced run each begun on an empty launch queue, so
that the call returns before the card finishes and reads the host's own
dispatch time.  (In the window the card paces the step, the queue is full
and the call waits on it.)"""


def read(r, trace):
    if r["kind"] not in ("train", "dp_train") or r["host_step_s"] is None:
        return None
    return r["host_step_s"] * 1e3
