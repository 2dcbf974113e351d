"""Dispatch layer: device launches a training step, kernels and memsets,
counted in the profiled stretch (rank 0's under data parallelism)."""


def read(r, trace):
    if trace is None or r["kind"] not in ("train", "dp_train"):
        return None
    return trace.launches() / trace.steps
