"""One run's settings, as a driver reads them."""

from __future__ import annotations

from typing import Any, NamedTuple

from perfbench import harness


class Context(NamedTuple):
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any          # the card (rank 0's under data parallelism)
    t_start: float       # the process's start, on time.perf_counter
    ranks: int = 1
    scale: float = 1.0   # < 1 only in the CPU tests: narrower widths
    work: dict | None = None

    @classmethod
    def for_cell(cls, cell: harness.Cell, **kw) -> "Context":
        scale = kw.pop("scale", 1.0)
        traffic = dict(cell.traffic, **kw.pop("traffic", {}))
        ranks = int(traffic.get("ranks", 1))
        return cls(cell=cell.name, config=cell.config, traffic=traffic, ranks=ranks,
                   scale=scale, work=cell_work(cell.config, traffic, scale), **kw)


def cell_work(config: dict, traffic: dict, scale: float = 1.0) -> dict:
    """The cell's counts from shapes, as the traffic's driver counts them
    (its ``cell_work``), for the per-layer readers."""
    return harness.driver(traffic["kind"]).cell_work(config, traffic, scale)
