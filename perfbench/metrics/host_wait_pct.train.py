"""Device layer: the share of the traced second stretch, from step 2 on,
in which the card sat idle before an operation whose launch record came
after the gap began, i.e. waiting on the host to launch it
(``program_trace``; rank 0's card under data parallelism).  The rest of
``device_idle_pct.train`` is gaps the card leaves between operations that
were already queued."""

from perfbench import program_trace


def read(r, trace):
    if r["kind"] not in ("train", "dp_train"):
        return None
    return program_trace.reading(r, "host_wait_pct", trace)
