"""Parallel layer (``parallel/dp.py`` ``reduce_gradients``,
``collectives.py``): rank 0's device milliseconds a step in NCCL's
collective kernels (the gradients' all-reduce and the metrics')."""

COLLECTIVE = "nccl"


def read(r, trace):
    if trace is None or r["kind"] != "dp_train":
        return None
    s = sum(min(o.end, trace.end) - max(o.start, trace.start) for o in trace.ops
            if o.cat == "kernel" and COLLECTIVE in o.name.lower()
            and o.end > trace.start and o.start < trace.end)
    return s * 1e-3 / trace.steps if s > 0 else None
