"""Plan layer (``infer/plan.py`` ``ExecutionPlan.logits``): host ms a
batch inside the ``plan.logits`` span over the traced second stretch
(``program_trace``): the dispatch of the plan's layers, to set beside the
batch's device time."""

from perfbench import program_trace


def read(r, trace):
    if r["kind"] != "infer":
        return None
    return program_trace.reading(r, "plan_host_ms", trace)
