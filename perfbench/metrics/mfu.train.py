"""Step layer (``core/les.py`` ``train_step``; ``parallel/dp.py`` under data
parallelism): the share of the cards' dense int8 peak that the window's
training operations fill.  Operations from ``work.py`` (every product the
LES step needs, counted from shapes) times the window's images, over the
window's wall time and 1,979 TOP/s a card."""

from perfbench import work


def read(r, trace):
    if r["kind"] not in ("train", "dp_train"):
        return None
    ops = r["work"]["train_ops_per_image"] * r["steps"] * r["batch"]
    return 100.0 * ops / r["window_s"] / (work.PEAK_OPS * r["chips"])
