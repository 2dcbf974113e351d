"""Traffic kind ``infer``: bulk classification through the compiled plan.

Set-up makes the weights (at the magnitude the traffic file names) and an
image set on the card from the seed, moves the images to pinned host
memory as int32 (the dtype the paper's pre-processing yields), freezes the
weights (``infer.export.freeze``) and compiles the plan
(``infer.plan.compile_plan``).  The window walks the host set as a ring, a
batch of contiguous images at a time, as an offline labelling job with two
buffers does: the batch is copied to the card, ``ExecutionPlan.logits``
runs on it, and its labels (the plan's argmax) are copied back to the
host, each batch; the host collects a batch's labels after it has issued
the next one.  Every label that came back is held against the plain
reference's, and the logits of a seeded sample of batches against the
reference's logits, once the window has closed and the plan is freed.
"""

from __future__ import annotations

import sys
import time

import torch

from perfbench import harness, work
from perfbench.reference import nitro as ref

LIMIT = 0


def inputs(ctx):
    """The weights and the image set from the seed; the images on the host, the first batch repeated at the end
    so that every batch of the ring is a contiguous view."""
    dev, config, tr = ctx.device, ctx.config, ctx.traffic
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    params = harness.seeded_params(config, gen, dev, ctx.scale, tr["weights"])
    x, _ = harness.seeded_images(tr["dataset_images"], config["input_shape"],
                                 config["num_classes"], gen, dev)
    host = torch.cat([x, x[:tr["batch"]]]).to(torch.int32).cpu()
    if dev.type == "cuda":
        host = host.pin_memory()
    return params, host


def sampled(seed: int, b: int, every: int) -> bool:
    """Whether batch ``b`` of the window keeps its logits for the check:
    the first, and one in ``every`` after it, chosen by the seed."""
    return b == 0 or b % every == seed % every


def cell_work(config: dict, traffic: dict, scale: float = 1.0) -> dict:
    """The cell's counts from shapes (``work.nitro_cell_work``), with each
    layer's weights at the width ``freeze`` stores them in: the narrowest
    integer type that holds the traffic's weight bound."""
    bound = harness.BOUNDS[traffic["weights"]]
    return work.nitro_cell_work(config, traffic, scale, lambda layers, batch: work.infer_entry_work(
        layers, batch, [harness.stored_bytes(bound(l.k * l.k * l.c)) for l in layers]))


def run(ctx) -> harness.Outcome:
    from repro_torch.infer.export import freeze
    from repro_torch.infer.plan import compile_plan

    tr, config, dev = ctx.traffic, ctx.config, ctx.device
    batch, n = tr["batch"], tr["dataset_images"]
    cfg = harness.program_config(config, batch, ctx.scale)
    net = harness.reference_net(config, batch, ctx.scale)
    params, host = inputs(ctx)
    plan = compile_plan(freeze(params, cfg), device=dev)
    harness.stage("weights, images and plan made", ctx.t_start)
    spans = harness.Spans()
    cuda = dev.type == "cuda"
    bufs = [torch.empty(batch, dtype=torch.int32, pin_memory=cuda) for _ in range(2)]
    b_no = 0

    def classify():
        """Issue one batch; returns (start, logits, its labels' buffer and
        the event after which the buffer holds them)."""
        nonlocal b_no
        s = (b_no * batch) % n
        with spans.span("batch"):
            x = host[s:s + batch].to(dev, non_blocking=True)
        with spans.span("plan.logits"):
            logits = plan.logits(x)
        with spans.span("readback"):
            buf = bufs[b_no % 2]
            buf.copy_(logits.argmax(dim=-1).to(torch.int32), non_blocking=True)
            ev = torch.cuda.Event() if cuda else None
            if cuda:
                ev.record()
        b_no += 1
        return s, logits, buf, ev

    def collect(issued, answers):
        s, _, buf, ev = issued
        with spans.span("readback"):
            if ev is not None:
                ev.synchronize()
            answers.append((s, buf.clone()))

    def drive(count=None, seconds=None, answers=None, kept=None):
        """Classify ``count`` batches, or until ``seconds`` have passed;
        every batch's labels are collected one batch behind."""
        answers = [] if answers is None else answers
        t0, done, prev = time.perf_counter(), 0, None
        while True:
            cur = classify()
            if kept is not None and sampled(ctx.seed, b_no - 1, tr["sample_every"]):
                kept.append((cur[0], cur[1]))
            if prev is not None:
                collect(prev, answers)
            prev = cur
            done += 1
            if (count is not None and done >= count) or (
                    seconds is not None and time.perf_counter() - t0 >= seconds):
                break
        collect(prev, answers)
        return answers

    drive(count=tr["warmup_batches"])
    b_no = 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    kept: list = []
    t0 = time.perf_counter()
    answers = drive(seconds=ctx.seconds, kept=kept)
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    images = len(answers) * batch

    trace_out: dict = {}
    if ctx.trace:
        k = tr["profile_batches"]
        with harness.profiled(spans, k, trace_out):
            drive(count=k)

    e2e = {"setup_s": t0 - ctx.t_start, "infer_images_per_s": images / wall,
           "peak_mem_gib": peak / 2 ** 30}
    readings = {"kind": "infer", "steps": len(answers), "window_s": wall, "batch": batch,
                "chips": 1, "work": ctx.work}
    kept = [(s, lg.cpu()) for s, lg in kept]
    del plan, params
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = checks_from(reference_logits(net, ctx, host), answers, kept)
    print(f"[reference] {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return harness.Outcome(e2e, readings, checks, images, 0, peak, trace_out.get("trace"))


def reference_logits(net, ctx, host, prec: str = "exact") -> torch.Tensor:
    """The plain reference's logits of every image of the set, from the
    benchmark's own weights, a batch at a time on the card."""
    dev, config, tr = ctx.device, ctx.config, ctx.traffic
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    params = harness.seeded_params(config, gen, dev, ctx.scale, tr["weights"])
    fw = [b["fw"]["w"] for b in params["blocks"]]
    n, batch = tr["dataset_images"], tr["batch"]
    out = [ref.logits(net, fw, params["output"]["w"], host[s:min(s + batch, n)].to(dev), prec)
           .cpu() for s in range(0, n, batch)]
    logits = torch.cat(out)
    return torch.cat([logits, logits[:batch]])


def checks_from(ref_all: torch.Tensor, answers, kept) -> dict:
    """Every label that came back against the reference's argmax, and the
    kept batches' logits against the reference's."""
    from perfbench.reference.nitro import argmax_first

    ref_labels = argmax_first(ref_all).to(torch.int32)
    wrong = sum(int((lab != ref_labels[s:s + len(lab)]).sum()) for s, lab in answers)
    gap = max((int((lg.to(torch.int64) - ref_all[s:s + len(lg)].to(torch.int64)).abs().max())
               for s, lg in kept), default=None)
    return {"labels_wrong": (wrong, LIMIT), "logit_gap": (gap, LIMIT)}

