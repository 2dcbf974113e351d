"""Traffic kind ``dp_train``: data-parallel LES training, one rank a card.

``parallel.dp.spawn`` starts the ranks (NCCL when each has its own card).
Every rank makes the same weights, image set and feed from the seed on its
card and drives the CLI's data-parallel step
(``dp.make_dp_train_step``: its rows of the global batch, the exact int32
all-reduce of the gradients and metrics, the update) through the checked
steps and into the window, with the training driver's pieces.  The ranks
end the window together: every few steps they agree over a host-side gloo
group whether any rank's clock has passed the window.  Rank 0's step
times and wall clock give the rates.  Once the ranks have ended, the
plain reference repeats the checked steps on the whole global batch, and
every rank's state is held against it.  Each rank reports the forbidden
modules (``harness.FORBIDDEN_MODULES``) in its own ``sys.modules`` once its
window and traced stretch are over, for ``harness.finish`` to refuse.
"""

from __future__ import annotations

import sys
import time

import torch

from perfbench import faults, harness
from perfbench.drivers import train


def cell_work(config: dict, traffic: dict, scale: float = 1.0) -> dict:
    """The cell's counts from shapes, a rank's step (``work.nitro_cell_work``)."""
    return train.cell_work(config, traffic, scale)


def run(ctx, fault: str | None = None) -> harness.Outcome:
    """``fault``: one of ``faults.NAMES``, planted in every rank (the CPU
    tests; the benchmark's runs plant none)."""
    from repro_torch.parallel import dp

    outs = dp.spawn(_rank, ctx.ranks, device=ctx.device.type, args=(ctx, fault))
    lead, tr = outs[0], ctx.traffic
    for r, o in enumerate(outs):
        train.note_window(o["window"], f" rank {r}")
    win = lead["window"]
    e2e = {"setup_s": win.t0 - ctx.t_start,
           "train_images_per_s": win.steps * tr["batch"] / win.wall,
           "train_step_ms_p95": harness.percentile(sorted(win.step_ms), 0.95),
           "peak_mem_gib": max(o["window"].peak for o in outs) / 2 ** 30}
    readings = {"kind": "dp_train", "steps": win.steps, "window_s": win.wall,
                "batch": tr["batch"], "chips": ctx.ranks, "host_step_s": lead["host_step_s"],
                "work": ctx.work}
    if lead["trace"] is not None:  # the busy time and stretch averaged over the cards
        readings["busy_s"] = sum(o["busy_s"] for o in outs) / len(outs)
        readings["trace_window_s"] = sum(o["trace_window_s"] for o in outs) / len(outs)
    t_ref = time.perf_counter()
    dev = ctx.device if ctx.device.type == "cpu" else torch.device("cuda", 0)
    net = harness.reference_net(ctx.config, tr["batch"], ctx.scale)
    checks = train.reference_checks(net, lead["checked"], dev, [o["checked"] for o in outs])
    print(f"[reference] {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    peak = max(o["window"].peak for o in outs)
    loaded = tuple(sorted({m for o in outs for m in o["loaded"]}))
    return harness.Outcome(e2e, readings, checks, win.steps, 0, peak, lead["trace"], loaded)


def _rank(axis, device, ctx, fault):
    with faults.planted(fault):
        out = _rank_run(axis, device, ctx._replace(device=device))
        out["loaded"] = harness.forbidden_loaded()
    return out


def _rank_run(axis, device, ctx) -> dict:
    import torch.distributed as dist

    from repro_torch.parallel import dp

    tr = ctx.traffic
    cfg = harness.program_config(ctx.config, tr["batch"], ctx.scale)
    params, data, labels, feed = train.inputs(ctx, tr["batch"])
    state = train.new_state(cfg, params, device)
    spans = harness.Spans()
    step = train.make_step(
        ctx, dp.make_dp_train_step(cfg, axis, dp_reduce=tr["reducer"], fuse_opt=tr["fuse_opt"]),
        data, labels, feed, spans)
    lead = axis.rank == 0
    state, checked = train.run_checked(step, state, tr["checked_steps"],
                                       "cpu" if lead else None)
    for _ in range(tr["warmup_steps"]):
        state, _, _ = step(state)

    stop_group = dist.new_group(backend="gloo")
    flag = torch.zeros(1, dtype=torch.int32)

    def stop(steps: int, elapsed: float) -> bool:
        """Every rank ends on the same step: any rank past the window ends it."""
        if steps % tr["stop_every"]:
            return False
        flag[0] = int(elapsed >= ctx.seconds)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=stop_group)
        return bool(flag[0])

    state, win = train.timed_window(step, state, ctx.seconds, device,
                                    ready=lambda: dist.barrier(group=stop_group), stop=stop)
    trace = host_step_s = None
    if ctx.trace:
        state, trace, host_step_s = train.traced(ctx, step, state, spans)
    dist.destroy_process_group(stop_group)
    return {"window": win, "checked": checked, "host_step_s": host_step_s,
            "trace": trace if lead else None,
            "busy_s": trace.busy_s if trace else None,
            "trace_window_s": trace.window_s if trace else None}
