"""obs_top — live terminal dashboard over the repro_torch.obs surfaces
(port of ``repro.launch.obs_top``).

``htop`` for an integer-only training run: one screen that answers "is
this run healthy *right now*" without grepping JSONL.  Three panels,
each fed by an existing observability surface (this tool adds **no** new
instrumentation — it is a pure reader):

  * **train health** — tails the run's ``metrics.jsonl`` (what
    ``launch/train.py --telemetry-every N`` appends): per-layer bit-
    occupancy sparklines, msb/int32-headroom, saturation fractions,
    dead-unit fractions, optimiser scalars;
  * **alerts** — the tail is replayed through the same
    ``obs.health.default_rules()`` engine the trainer runs, so the
    active-alert list here is exactly what the run printed;
  * **fleet** — scrapes a serving process's ``/metrics.json``
    (``--fleet-url``, e.g. ``serve_vision --metrics-port``) or reads a
    dumped snapshot (``--fleet-json``): per-model queue depth, batch
    fill, and p99-vs-SLO from the deadline-slack histograms.

Modes:

  * ``--once`` — render one deterministic plain-text frame and exit
    (post-mortem over a finished run; golden-file tested, so the frame
    contains no wall-clock);
  * live (default) — redraw every ``--interval`` seconds, with curses
    when stdout is a tty and a plain scrolling fallback otherwise.

Usage::

    python -m repro_torch.launch.obs_top --metrics ckpt/metrics.jsonl --once
    python -m repro_torch.launch.obs_top --metrics ckpt/metrics.jsonl \
        --fleet-url http://127.0.0.1:9100/metrics.json
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import urllib.request

from repro_torch.obs import health as H

#: Eight-level bar glyphs for bit-occupancy sparklines.
SPARK = "▁▂▃▄▅▆▇█"

#: Sampled-step window the rule engine replays over (matches the
#: largest default rule window so hysteresis state is exact).
TAIL_STEPS = 64


def sparkline(counts) -> str:
    """Counts → one glyph per bucket, log-scaled (telemetry histograms
    span orders of magnitude; linear scaling flattens everything but the
    mode).  Zero stays visually empty (a space), so the *occupied
    envelope* — the thing the NITRO-D eye looks for — reads directly."""
    logs = [math.log1p(c) for c in counts]
    top = max(logs) or 1.0
    return "".join(
        " " if not v else SPARK[min(int(v / top * (len(SPARK) - 1)),
                                    len(SPARK) - 1)]
        for v in logs
    )


def read_jsonl_tail(path: str, *, steps: int = TAIL_STEPS) -> list[dict]:
    """The last ``steps`` sampled steps' rows from a telemetry JSONL."""
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    grouped = H.group_steps(records)
    keep = {step for step, _ in grouped[-steps:]}
    return [r for r in records if int(r.get("step", -1)) in keep]


# ---------------------------------------------------------------------------
# Train panel
# ---------------------------------------------------------------------------


def render_train_panel(records: list[dict],
                       monitor: H.HealthMonitor) -> list[str]:
    """Per-layer table + optimiser scalars for the latest sampled step."""
    grouped = H.group_steps(records)
    if not grouped:
        return ["train: no telemetry rows yet"]
    step, rows = grouped[-1]
    lines = [
        f"train health — step {step} "
        f"({len(grouped)} sampled step(s) in window)",
        f"{'layer':<10} {'kind':<7} {'w.msb':>5} {'g.msb':>5} "
        f"{'hdrm':>4} {'sat8%':>6} {'dead%':>6}  act bits 0..32",
    ]
    for layer in sorted(rows):
        row = rows[layer]
        if layer.startswith("_"):
            continue
        w, g, act = row.get("weight"), row.get("grad"), row.get("act")
        msbs = [t["msb"] for t in (w, g, act) if t]
        hdrm = H.INT32_BITS - max(msbs) if msbs else "-"
        sat8 = (f"{100 * act['sat_int8_frac']:.1f}" if act else "    -")
        dead = (f"{100 * row['dead_frac']:.1f}"
                if "dead_frac" in row else "    -")
        spark = sparkline(act["bit_hist"]) if act else ""
        lines.append(
            f"{layer:<10} {row.get('kind', '?'):<7} "
            f"{w['msb'] if w else '-':>5} {g['msb'] if g else '-':>5} "
            f"{hdrm:>4} {sat8:>6} {dead:>6}  {spark}"
        )
    opt = rows.get("_opt")
    if opt:
        scalars = " ".join(f"{k}={opt[k]}" for k in sorted(opt)
                           if k not in ("step", "layer"))
        lines.append(f"opt: {scalars}")
    dp = rows.get("_dp")
    if dp:
        fits = "yes" if dp.get("grad_fits_int16") else "NO"
        lines.append(f"dp:  shards={dp.get('shards')} "
                     f"grads fit int16 limbs: {fits}")
    return lines


def render_alerts_panel(monitor: H.HealthMonitor) -> list[str]:
    active = monitor.active_alerts()
    by_sev = monitor.summary()["by_severity"]
    fired = ", ".join(f"{k}={v}" for k, v in by_sev.items() if v) or "none"
    lines = [f"alerts — fired: {fired}; active: {len(active)}"]
    for a in active:
        lines.append(f"  {a.format()}")
    return lines


# ---------------------------------------------------------------------------
# Fleet panel (from a MetricRegistry JSON snapshot)
# ---------------------------------------------------------------------------


def quantile_from_buckets(buckets, count: int, q: float) -> float | None:
    """Upper-bound estimate of a quantile from cumulative buckets.

    The smallest bucket upper bound whose cumulative count reaches
    ``ceil(q·count)`` — the standard scrape-side histogram estimate
    (exact at bucket resolution; +Inf falls back to the last finite
    bound).  ``buckets`` is the JSON exposition: [[ub|"+Inf", cum], …].
    """
    if not count:
        return None
    rank = max(math.ceil(q * count), 1)
    last_finite = None
    for ub, cum in buckets:
        if ub == "+Inf":
            break
        last_finite = float(ub)
        if cum >= rank:
            return float(ub)
    return last_finite


def _samples(snapshot: dict, name: str) -> list[dict]:
    fam = snapshot.get(name)
    return fam["samples"] if fam else []


def _by_model(snapshot: dict, name: str) -> dict[str, dict]:
    return {s["labels"].get("model", ""): s
            for s in _samples(snapshot, name)}


def render_fleet_panel(snapshot: dict) -> list[str]:
    """Queue depth / batch fill / p99-vs-SLO from a ``json_snapshot``."""
    depth = _by_model(snapshot, "serve_queue_depth")
    requests = _by_model(snapshot, "serve_requests_total")
    deadlines = _by_model(snapshot, "serve_slo_deadline_seconds")
    slack = _by_model(snapshot, "serve_request_deadline_seconds")
    violations = _by_model(snapshot, "serve_slo_violations_total")

    lines = ["fleet"]
    fill = _samples(snapshot, "serve_batch_fill")
    if fill:
        s = fill[0]
        avg = s["sum"] / s["count"] if s["count"] else 0.0
        lines.append(f"batches: {s['count']}  avg fill {avg:.2f}")

    models = sorted(set(depth) | set(requests) | set(deadlines))
    models = [m for m in models if m]
    if models:
        lines.append(f"{'model':<12} {'queue':>5} {'reqs':>7} "
                     f"{'slo_ms':>7} {'p99_ms':>7} {'viol':>6}")
    for m in models:
        q = depth.get(m, {}).get("value", 0)
        n = requests.get(m, {}).get("value", 0)
        slo_s = deadlines.get(m, {}).get("value")
        slo_ms = f"{1e3 * slo_s:.1f}" if slo_s is not None else "-"
        p99_ms, viol = "-", "-"
        sl = slack.get(m)
        if sl and sl.get("count"):
            # p99 latency = 1st-percentile slack: latency = deadline − slack
            s01 = quantile_from_buckets(sl["buckets"], sl["count"], 0.01)
            if s01 is not None and slo_s is not None:
                p99_ms = f"{1e3 * (slo_s - s01):.1f}"
            v = violations.get(m, {}).get("value", 0)
            viol = f"{v}/{sl['count']}"
        lines.append(f"{m:<12} {q:>5} {n:>7} {slo_ms:>7} {p99_ms:>7} "
                     f"{viol:>6}")
    if len(lines) == 1:
        lines.append("no serving metrics in snapshot")
    return lines


def fetch_fleet_snapshot(url: str | None, path: str | None) -> dict | None:
    if path:
        with open(path) as f:
            return json.load(f)
    if url:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.loads(resp.read().decode())
    return None


# ---------------------------------------------------------------------------
# Frame assembly + modes
# ---------------------------------------------------------------------------


def render_frame(metrics_path: str | None, fleet: dict | None) -> str:
    """One full dashboard frame as plain text (the golden-tested unit).

    Deliberately wall-clock-free: everything in the frame derives from
    the inputs, so the same jsonl + snapshot always render the same
    frame (what the golden-file test and ``--once`` rely on).
    """
    sections: list[list[str]] = []
    if metrics_path:
        records = read_jsonl_tail(metrics_path)
        monitor = H.HealthMonitor()
        monitor.observe_records(records)
        sections.append(render_train_panel(records, monitor))
        sections.append(render_alerts_panel(monitor))
    if fleet is not None:
        sections.append(render_fleet_panel(fleet))
    if not sections:
        sections.append(["nothing to show: pass --metrics and/or "
                         "--fleet-url/--fleet-json"])
    rule = "-" * 72
    body = f"\n{rule}\n".join("\n".join(s) for s in sections)
    return f"{rule}\n{body}\n{rule}"


def _live_loop(args) -> None:
    """Redraw loop: curses when interactive, scrolling frames otherwise."""

    def frame() -> str:
        try:
            fleet = fetch_fleet_snapshot(args.fleet_url, args.fleet_json)
        except OSError as e:
            fleet = None
            return render_frame(args.metrics, None) + f"\nfleet: {e}"
        return render_frame(args.metrics, fleet)

    if not sys.stdout.isatty():
        while True:
            print(frame(), flush=True)
            time.sleep(args.interval)

    import curses

    def ui(stdscr):
        curses.curs_set(0)
        stdscr.nodelay(True)
        while True:
            stdscr.erase()
            maxy, maxx = stdscr.getmaxyx()
            for y, line in enumerate(frame().splitlines()[:maxy - 1]):
                stdscr.addnstr(y, 0, line, maxx - 1)
            stdscr.addnstr(maxy - 1, 0, "q to quit", maxx - 1,
                           curses.A_REVERSE)
            stdscr.refresh()
            t_end = time.monotonic() + args.interval
            while time.monotonic() < t_end:
                if stdscr.getch() in (ord("q"), ord("Q")):
                    return
                time.sleep(0.05)

    curses.wrapper(ui)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs_top", description="live dashboard over repro_torch.obs")
    ap.add_argument("--metrics",
                    help="telemetry JSONL from launch/train.py "
                         "--telemetry-every (tailed each frame)")
    ap.add_argument("--fleet-url",
                    help="a serving /metrics.json URL to scrape "
                         "(serve_vision --metrics-port)")
    ap.add_argument("--fleet-json",
                    help="a dumped /metrics.json snapshot file "
                         "(post-mortem alternative to --fleet-url)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (deterministic "
                         "plain text; post-mortem mode)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="live-mode refresh seconds (default 2)")
    args = ap.parse_args(argv)

    if args.once:
        print(render_frame(args.metrics,
                           fetch_fleet_snapshot(args.fleet_url,
                                                args.fleet_json)))
        return 0
    try:
        _live_loop(args)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
