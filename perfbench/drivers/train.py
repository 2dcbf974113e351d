"""Traffic kind ``train``: integer-only LES training on one card.

Set-up makes the weights, a shuffled image set and the labels on the card
from the seed, builds one ``TrainState`` and drives it through the
window's own call and feed (``les.train_step(..., fuse_opt=...)`` on
shuffled batches of distinct rows) for the checked steps; the same state
goes on into the window.  The window counts every step it issues; step
times are the intervals between CUDA events recorded at each step's end,
read once the window has closed.  Then the program's state is freed and
the plain reference repeats the checked steps from the same weights,
batches and keys.  The data-parallel driver shares these pieces.
"""

from __future__ import annotations

import sys
import time
from typing import Any, NamedTuple

import torch

from perfbench import compare, harness, work
from perfbench.reference import nitro as ref


class Feed:
    """Shuffled batches of distinct rows: a permutation of the image set
    per epoch, drawn on the card; the ragged tail of an epoch is dropped."""

    def __init__(self, n: int, batch: int, gen, device):
        self.n, self.batch, self.gen, self.device = n, batch, gen, device
        self.perm, self.pos = None, n

    def next(self) -> torch.Tensor:
        if self.pos + self.batch > self.n:
            self.perm = torch.randperm(self.n, generator=self.gen, device=self.device)
            self.pos = 0
        idx = self.perm[self.pos:self.pos + self.batch]
        self.pos += self.batch
        return idx


def inputs(ctx, batch: int):
    """What the seed makes, in a fixed order on one card generator: the
    weights, the image set and its labels, and the shuffled feed."""
    dev, config = ctx.device, ctx.config
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    params = harness.seeded_params(config, gen, dev, ctx.scale, ctx.traffic["weights"])
    n = ctx.traffic["dataset_images"]
    data, labels = harness.seeded_images(n, config["input_shape"], config["num_classes"],
                                         gen, dev)
    return params, data, labels, Feed(n, batch, gen, dev)


def new_state(cfg, params, dev):
    """A ``TrainState`` on the benchmark's weights, with both IntegerSGD
    states as the program makes them (γ_inv and γ_inv·AF, each η_inv)."""
    from repro_torch.core import les
    from repro_torch.core import optimizer as opt

    af = opt.amplification_factor(cfg.num_classes)
    return les.TrainState(
        params=params, opt_lr=opt.init_state(cfg.gamma_inv, cfg.eta_lr, device=dev),
        opt_fw=opt.init_state(cfg.gamma_inv * af, cfg.eta_fw, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def make_step(ctx, call, data, labels, feed, spans):
    """The window's step: the next shuffled batch and its key (span
    ``batch``), then ``call(state, x, labels, key)`` (span ``train_step``);
    returns (state, metrics, (x, labels, key))."""
    step_no = 0

    def step(state):
        nonlocal step_no
        with spans.span("batch"):
            idx = feed.next()
            x, y = data[idx], labels[idx]
            key = harness.step_key(ctx.seed, step_no)
        with spans.span("train_step"):
            state, metrics = call(state, x, y, key)
        step_no += 1
        return state, metrics, (x, y, key)

    return step


def _opt_tensors(state) -> list:
    return [state.opt_lr.gamma_inv, state.opt_lr.eta_inv,
            state.opt_fw.gamma_inv, state.opt_fw.eta_inv, state.step]


class Checked(NamedTuple):
    """The checked steps as the program ran them: the weights before, the
    batches and keys, the weights after the first and the last step, each
    step's metrics, and the optimiser state and step counter after it."""

    w0: Any
    inputs: list
    prog_w: list
    prog_metrics: list
    prog_opt: list


def run_checked(step, state, n: int, keep_on):
    """Drive ``state`` through the ``n`` checked steps; their batches are
    kept on ``keep_on`` (None: not kept)."""
    w0 = harness.tree_to(state.params, "cpu")
    kept, prog_w, prog_metrics = [], [], []
    for t in range(n):
        state, m, fed = step(state)
        if keep_on is not None:
            kept.append(tuple(harness.tree_to(list(fed[:2]), keep_on)) + (fed[2],))
        prog_metrics.append(harness.tree_to([m.loss, m.correct, m.local_losses], "cpu"))
        if t in (0, n - 1):
            prog_w.append(harness.tree_to(state.params, "cpu"))
    return state, Checked(w0, kept, prog_w, prog_metrics,
                          harness.tree_to(_opt_tensors(state), "cpu"))


class Window(NamedTuple):
    t0: float         # its start, on perf_counter
    wall: float       # seconds, ended by a synchronize
    steps: int
    step_ms: list     # each step's interval between CUDA events
    peak: int         # max_memory_allocated over it


def timed_window(step, state, seconds: float, dev, ready=None, stop=None):
    """Issue steps until ``seconds`` have passed (or until
    ``stop(steps, elapsed)`` says so), recording a CUDA event at each
    step's end; the events are read once the window has closed.  ``ready``
    runs after the synchronize that opens the window."""
    timed = dev.type == "cuda"
    if timed:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if ready is not None:
        ready()
    ends = []
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    steps = 0
    while True:
        state, _, _ = step(state)
        steps += 1
        if timed:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        elapsed = time.perf_counter() - t0
        if stop(steps, elapsed) if stop is not None else elapsed >= seconds:
            break
    if timed:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if timed:
        step_ms = [a.elapsed_time(b) for a, b in zip([start] + ends[:-1], ends)]
    else:
        step_ms = [wall / steps * 1e3] * steps
    peak = torch.cuda.max_memory_allocated(dev) if timed else 0
    return state, Window(t0, wall, steps, step_ms, peak)


def note_window(win: Window, who: str = "") -> None:
    """The window's step times on stderr: the median, the slowest five
    with their places, and how many steps took over twice the median."""
    if not win.step_ms:
        return
    med = harness.percentile(sorted(win.step_ms), 0.5)
    slow = sorted(range(win.steps), key=lambda i: -win.step_ms[i])[:5]
    print(f"[window]{who} {win.steps} steps in {win.wall:.3f} s, median {med:.3f} ms, "
          f"over 2x median {sum(t > 2 * med for t in win.step_ms)}, slowest "
          + ", ".join(f"{win.step_ms[i]:.3f} ms (step {i})" for i in slow), file=sys.stderr)


def traced(ctx, step, state, spans):
    """The ``--trace 1`` readings after the window: a profiled stretch of
    the traffic's ``profile_steps``, then the host's own time in the step
    call over ``host_probe_steps``, each begun on an empty launch queue
    (in the window the queue is full and the call waits for the card).
    Returns the state, the trace and the mean host seconds."""
    out: dict = {}
    n = ctx.traffic["profile_steps"]
    with harness.profiled(spans, n, out):
        for _ in range(n):
            state, _, _ = step(state)
    since = time.perf_counter()
    for _ in range(ctx.traffic["host_probe_steps"]):
        torch.cuda.synchronize(ctx.device)
        state, _, _ = step(state)
    return state, out["trace"], spans.mean_s("train_step", since)


def cell_work(config: dict, traffic: dict, scale: float = 1.0) -> dict:
    """The cell's counts from shapes (``work.nitro_cell_work``)."""
    return work.nitro_cell_work(config, traffic, scale, work.train_entry_work)


def run(ctx) -> harness.Outcome:
    from repro_torch.core import les

    tr, dev = ctx.traffic, ctx.device
    batch = tr["batch"]
    cfg = harness.program_config(ctx.config, batch, ctx.scale)
    params, data, labels, feed = inputs(ctx, batch)
    state = new_state(cfg, params, dev)
    harness.stage("weights and images made", ctx.t_start)
    spans = harness.Spans()
    step = make_step(ctx, lambda st, x, y, key: les.train_step(
        st, cfg, x, y, key, fuse_opt=tr["fuse_opt"]), data, labels, feed, spans)

    state, checked = run_checked(step, state, tr["checked_steps"], dev)
    harness.stage("checked steps run", ctx.t_start)
    for _ in range(tr["warmup_steps"]):
        state, _, _ = step(state)
    state, win = timed_window(step, state, ctx.seconds, dev)
    note_window(win)
    trace = host_step_s = None
    if ctx.trace:
        state, trace, host_step_s = traced(ctx, step, state, spans)

    e2e = {"setup_s": win.t0 - ctx.t_start,
           "train_images_per_s": win.steps * batch / win.wall,
           "train_step_ms_p95": harness.percentile(sorted(win.step_ms), 0.95),
           "peak_mem_gib": win.peak / 2 ** 30}
    readings = {"kind": "train", "steps": win.steps, "window_s": win.wall, "batch": batch,
                "chips": 1, "host_step_s": host_step_s, "work": ctx.work}

    # free the program's state, then the reference's checked steps
    del state, data, labels, feed, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    net = harness.reference_net(ctx.config, batch, ctx.scale)
    checks = reference_checks(net, checked, dev)
    print(f"[reference] {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return harness.Outcome(e2e, readings, checks, win.steps, 0, win.peak, trace)


def reference_steps(net, w0, steps, dev, prec: str = "exact"):
    """The plain reference's steps from ``w0`` on the given batches and
    keys: the weights after the first and the last, and each step's
    metrics."""
    params = harness.tree_to(w0, dev)
    ref_w, ref_metrics = [], []
    for t, (x, y, key) in enumerate(steps):
        out = ref.train_step(net, params, x, y, key, prec)
        params = out.params
        ref_metrics.append(harness.tree_to([out.loss, out.correct, out.local_losses], "cpu"))
        if t in (0, len(steps) - 1):
            ref_w.append(harness.tree_to(params, "cpu"))
    return ref_w, ref_metrics


def expected_opt(net, steps: int) -> list:
    """The optimiser scalars and step counter a sound state holds after
    ``steps`` steps (no step changes γ_inv or η_inv)."""
    af = ref.amplification(net.num_classes)
    return [torch.tensor(v, dtype=torch.int32) for v in
            (net.gamma_inv, net.eta_lr, net.gamma_inv * af, net.eta_fw, steps)]


def reference_checks(net, checked: Checked, dev, programs=None) -> dict:
    """The plain reference's run of the checked steps held against the
    program's: against each of ``programs`` (every rank's readings of the
    same steps; default ``checked`` alone), the worst reading of each
    number."""
    ref_w, ref_metrics = reference_steps(net, checked.w0, checked.inputs, dev)
    opt = expected_opt(net, len(checked.inputs))
    worst: dict = {}
    for p in programs or [checked]:
        for k, (v, lim) in compare.training_checks(checked.w0, p.prog_w, p.prog_metrics,
                                                   p.prog_opt, ref_w, ref_metrics,
                                                   opt).items():
            if k not in worst or v > worst[k][0]:
                worst[k] = (v, lim)
    return worst
