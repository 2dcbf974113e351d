"""Plan layer (``infer/plan.py`` ``ExecutionPlan``): the share of the card's
dense int8 peak that the window's forward operations fill (``work.py``'s
count from shapes, times the images classified, over the window's wall
time and 1,979 TOP/s)."""

from perfbench import work


def read(r, trace):
    if r["kind"] != "infer":
        return None
    ops = r["work"]["infer_ops_per_image"] * r["steps"] * r["batch"]
    return 100.0 * ops / r["window_s"] / work.PEAK_OPS
