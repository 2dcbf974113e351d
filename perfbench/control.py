"""The readings that the limits of ``correct`` are set from: the control and
the planted faults, on the card at a cell's own size.  The benchmark's own
runs do not run this.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's inputs as a run does and prints one JSON
line of readings, each the cell's numbers as a run compares them:

  * ``control``        — the plain reference in the program's place,
    computed in float32 (TF32 off), against the exact reference;
  * ``half_batch``     — training: the reference on the first half of each
    batch against the whole batch; serving: the second half of every
    batch answered with the first half's logits;
  * ``no_exchange``    — data parallelism: rank 0's update from its own rows
    alone (the reference on the first quarter of each global batch);
  * ``answer_altered`` — serving: one logit of every batch off by one.

A state left unchanged reads 1 on the norm gaps by construction (no run).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from perfbench import compare, context, harness  # noqa: E402
from perfbench.drivers import infer, train  # noqa: E402


def training(ctx, rows_fault: tuple) -> dict:
    batch = ctx.traffic["batch"]
    net = harness.reference_net(ctx.config, batch, ctx.scale)
    params, data, labels, feed = train.inputs(ctx, batch)
    checked = []
    for t in range(ctx.traffic["checked_steps"]):
        idx = feed.next()
        checked.append((data[idx].clone(), labels[idx].clone(), harness.step_key(ctx.seed, t)))
    w0 = harness.tree_to(params, "cpu")
    del params, data, labels, feed
    dev = ctx.device
    ref_w, ref_m = train.reference_steps(net, w0, checked, dev)
    opt = train.expected_opt(net, len(checked))
    out = {}
    f32_w, f32_m = train.reference_steps(net, w0, checked, dev, "float32")
    out["control"] = compare.training_checks(w0, f32_w, f32_m, opt, ref_w, ref_m, opt)
    for name, frac in rows_fault:
        part = [(x[:int(len(x) * frac)], y[:int(len(y) * frac)], k) for x, y, k in checked]
        f_w, f_m = train.reference_steps(net, w0, part, dev)
        out[name] = compare.training_checks(w0, f_w, f_m, opt, ref_w, ref_m, opt)
    return out


def serving(ctx) -> dict:
    tr = ctx.traffic
    batch, n = tr["batch"], tr["dataset_images"]
    net = harness.reference_net(ctx.config, batch, ctx.scale)
    _, host = infer.inputs(ctx)
    exact = infer.reference_logits(net, ctx, host)
    f32 = infer.reference_logits(net, ctx, host, "float32")
    starts = [(b * batch) % n for b in range(-(-n // batch))]
    kept_b = [b for b in range(len(starts)) if infer.sampled(ctx.seed, b, tr["sample_every"])]

    def readings(logits_of):
        answers = [(s, logits_of(s).argmax(-1).to(torch.int32)) for s in starts]
        kept = [(starts[b], logits_of(starts[b])) for b in kept_b]
        return infer.checks_from(exact, answers, kept)

    def halved(s):
        lg = exact[s:s + batch]
        return lg[:batch // 2].repeat(2, 1)[:batch]

    def altered(s):
        lg = exact[s:s + batch].clone()
        lg[0, 0] += 1
        return lg

    return {"control": readings(lambda s: f32[s:s + batch]),
            "half_batch": readings(halved), "answer_altered": readings(altered)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = context.Context.for_cell(cell, seed=seed, seconds=0.0, trace=False, device=dev,
                                       t_start=t0)
        kind = cell.traffic["kind"]
        if kind == "infer":
            out = serving(ctx)
        elif kind == "dp_train":
            out = training(ctx, (("no_exchange", 1 / ctx.ranks), ("half_batch", 0.5)))
        else:
            out = training(ctx, (("half_batch", 0.5),))
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds": time.perf_counter() - t0,
                          **{k: {n: v for n, (v, _) in c.items()} for k, c in out.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
