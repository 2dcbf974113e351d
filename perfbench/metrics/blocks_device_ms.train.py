"""Blocks layer (``core/blocks.py``, ``core/layers.py``, the step's own
tensor ops in ``core/les.py``): device ms a step of the operations that
``step.train`` launched outside every ``dispatch.*`` span (pooling,
dropout's threefry, the learning layers and their IntegerSGD, the casts
and masks between kernels), over steps 2 on of the traced second stretch
(``program_trace``; rank 0's under data parallelism)."""

from perfbench import program_trace


def read(r, trace):
    if r["kind"] not in ("train", "dp_train"):
        return None
    return program_trace.reading(r, "blocks_device_ms", trace)
