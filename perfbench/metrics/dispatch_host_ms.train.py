"""Dispatch layer (``kernels/*/ops.py``, ``core/numerics.py``
``int_matmul``, the CUDA wrappers under them): host ms a step inside the
outermost ``dispatch.*`` spans, over the traced second host probe, whose
steps each begin on an empty launch queue (``program_trace``; rank 0's
under data parallelism).  The rest of ``host_ms_per_step.train`` is the
eager torch ops of the blocks and the step."""

from perfbench import program_trace


def read(r, trace):
    if r["kind"] not in ("train", "dp_train"):
        return None
    return program_trace.reading(r, "dispatch_host_ms", trace)
