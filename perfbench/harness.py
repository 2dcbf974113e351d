"""What every cell of the benchmark shares: finding a cell's files by name,
the inputs made from the seed, host spans, the reading of the profiler's
trace, the comparison's bookkeeping and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``), whose ``kind`` names the module that runs
it and counts its work (``drivers/<kind>.py``: ``run`` and ``cell_work``).
Per-layer metrics are readers in ``metrics/<metric>.py``.  Adding one of
each adds files and entries only: nothing on the common path (``resolve``,
``context.Context.for_cell``, ``result_line``, ``finish``) reads a key of
the configuration, so a configuration of any kind joins through a driver
of its own.  The NITRO-D block nets' own pieces, which only their
drivers, readers and ``program_trace`` call, are ``blocks``, ``gamma_inv``,
``reference_net``, ``program_config``, ``weight_shapes`` and
``seeded_params``.

A metric's name may begin with a family of cells and a dot:
``dp.train_images_per_s`` is the quantity ``train_images_per_s`` in the
cells whose runs spread alike, kept apart so that each family has a bound
of its own.  Its value is the driver's reading of the quantity, and a
per-layer metric of a family with no reader of its own is read by the
quantity's reader (``dp.mfu.train`` by ``metrics/mfu.train.py``).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, NamedTuple

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "perfbench"

#: Top-level module names that must not be loaded: the JAX stack and the
#: JAX package (compared whole: the port's name begins with the latter's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

M32 = 0xFFFFFFFF


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    base: Path = BENCH_DIR  # the directory its files and readers lie in


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict | None = None, base: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and the
    metrics it reports, each read from its own file under ``base``."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    config = load_json(base / "configs" / f"{w['config']}.json")
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], base)


def driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def quantity(name: str, known) -> str:
    """The longest of ``name`` and its endings after a dot that ``known``
    holds: the quantity a metric of a family reports."""
    q = name
    while q not in known and "." in q:
        q = q.split(".", 1)[1]
    if q not in known:
        raise KeyError(f"no reading of metric {name!r}")
    return q


def metric_reader(name: str, base: Path = BENCH_DIR):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    that of its quantity (``quantity``)."""
    have = {p.stem for p in (base / "metrics").glob("*.py")}
    path = base / "metrics" / f"{quantity(name, have)}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an ascending sequence: the
    ``max(ceil(q·n), 1)``-th smallest value."""
    n = len(sorted_vals)
    if not n:
        raise ValueError("percentile of no values")
    return sorted_vals[min(max(math.ceil(q * n), 1), n) - 1]


# ---------------------------------------------------------------------------
# The configuration, as both sides run it
# ---------------------------------------------------------------------------


def _scaled(x: int, scale: float) -> int:
    return x if scale == 1.0 else max(int(round(x * scale)), 8)


def blocks(config: dict, scale: float = 1.0) -> list[dict]:
    """The configuration's blocks; ``scale`` < 1 narrows every width (the
    CPU tests only)."""
    out = []
    for b in config["blocks"]:
        conv = b["kind"] == "conv"
        out.append({
            "kind": b["kind"], "out": _scaled(b["out"], scale),
            "pool": bool(b.get("pool", False)),
            "dropout": config["p_c"] if conv else config["p_l"],
            "d_lr": _scaled(config["d_lr"], scale),
            "alpha_inv": config["alpha_inv"], "k": config["kernel_size"] if conv else 1,
        })
    return out


def gamma_inv(config: dict, batch: int) -> int:
    """γ_inv at ``batch``: the paper's value at its batch, scaled with the
    batch so that a step moves a weight as far per image."""
    return config["gamma_inv"] * batch // config["gamma_inv_batch"]


def reference_net(config: dict, batch: int, scale: float = 1.0):
    from perfbench.reference.nitro import Block, Net

    return Net(
        blocks=tuple(Block(b["kind"], b["out"], b["pool"], b["dropout"], b["d_lr"],
                           b["alpha_inv"], b["k"]) for b in blocks(config, scale)),
        input_shape=tuple(config["input_shape"]), num_classes=config["num_classes"],
        gamma_inv=gamma_inv(config, batch), eta_fw=config["eta_fw"], eta_lr=config["eta_lr"])


def program_config(config: dict, batch: int, scale: float = 1.0):
    """The program's ``NitroConfig`` for the same configuration."""
    from repro_torch.core.blocks import BlockSpec
    from repro_torch.core.model import NitroConfig

    specs = tuple(BlockSpec(b["kind"], b["out"], pool=b["pool"], dropout=b["dropout"],
                            d_lr=b["d_lr"], alpha_inv=b["alpha_inv"],
                            kernel_size=b["k"] if b["kind"] == "conv" else 3)
                  for b in blocks(config, scale))
    return NitroConfig(blocks=specs, input_shape=tuple(config["input_shape"]),
                       num_classes=config["num_classes"],
                       gamma_inv=gamma_inv(config, batch), eta_fw=config["eta_fw"],
                       eta_lr=config["eta_lr"], name=config["name"])


def weight_shapes(config: dict, scale: float = 1.0) -> list[tuple]:
    """(path, shape, fan_in) of every weight: each block's forward and
    learning layer, then the output layer."""
    from perfbench import work

    layers = work.layers(blocks(config, scale), config["input_shape"], config["num_classes"])
    g = config["num_classes"]
    out = []
    for i, l in enumerate(layers):
        if l.kind == "output":
            out.append((("output",), (l.c, l.f), l.c))
            continue
        fw = (l.k, l.k, l.c, l.f) if l.kind == "conv" else (l.c, l.f)
        out.append((("blocks", i, "fw"), fw, l.k * l.k * l.c))
        out.append((("blocks", i, "lr"), (l.lr_features, g), l.lr_features))
    return out


def kaiming_bound(fan_in: int) -> int:
    """Integer Kaiming (Appendix B.1): b = ⌊128·1732 / (⌊√fan_in⌋·1000)⌋."""
    return max((128 * 1732) // (max(math.isqrt(fan_in), 1) * 1000), 1)


def served_bound(fan_in: int) -> int:
    """The bound of the served weights: a trained model's magnitude, at
    which NITRO Scaling keeps a layer's z* spread over the activation range
    (std about 50 for inputs of std 40-60), narrowed to int16:
    b = min(576·⌊√fan_in⌋, 2¹⁵ − 1)."""
    return min(576 * max(math.isqrt(fan_in), 1), (1 << 15) - 1)


BOUNDS = {"init": kaiming_bound, "served": served_bound}


def stored_bytes(bound: int) -> int:
    """Bytes of the narrowest integer type that holds every value in
    [−bound, bound]: the width ``infer.export.freeze`` stores a weight in."""
    return 1 if bound <= 127 else 2 if bound <= 32767 else 4


def seeded_params(config: dict, gen, device, scale: float = 1.0, weights: str = "init") -> dict:
    """Every weight drawn U(−b, b) from one draw of ``gen`` on ``device``,
    b by the rule ``weights`` names (``BOUNDS``): the parameter tree both
    sides start from."""
    import torch

    bound = BOUNDS[weights]
    shapes = weight_shapes(config, scale)
    total = sum(math.prod(s) for _, s, _ in shapes)
    raw = torch.randint(0, 1 << 62, (total,), generator=gen, device=device, dtype=torch.int64)
    params: dict = {"blocks": [{} for _ in range(len(config["blocks"]))], "output": None}
    at = 0
    for path, shape, fan_in in shapes:
        n, b = math.prod(shape), bound(fan_in)
        w = ((raw[at:at + n] % (2 * b + 1)) - b).to(torch.int32).reshape(shape)
        at += n
        if path[0] == "output":
            params["output"] = {"w": w}
        else:
            params["blocks"][path[1]][path[2]] = {"w": w}
    return params


def seeded_images(n: int, shape, num_classes: int, gen, device):
    """``n`` synthetic images and labels from ``gen`` on ``device``: pixels
    uniform in [0, 255], standardised by the paper's integer pre-processing
    over the whole set (Appendix B.2: x̂ = ⌊(x − μ)·51 / ω⌋), stored int8."""
    import torch

    raw = torch.randint(0, 256, (n, *shape), generator=gen, device=device, dtype=torch.int32)
    count = raw.numel()
    mu = torch.div(raw.sum(dtype=torch.int64), count, rounding_mode="floor")
    omega = torch.div((raw.to(torch.int64) - mu).abs().sum(), count,
                      rounding_mode="floor").clamp(min=1)
    x = torch.div((raw.to(torch.int64) - mu) * 51, omega, rounding_mode="floor").to(torch.int8)
    labels = torch.randint(0, num_classes, (n,), generator=gen, device=device)
    return x, labels


def step_key(seed: int, step: int):
    """The dropout key of step ``step``: two uint32 words from the seed."""
    import torch

    return torch.tensor([(seed >> 32) & M32, (seed + step) & M32], dtype=torch.int64)


def tree_to(tree, device):
    """A copy of a tensor tree on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.detach().to(device, copy=True)


def leaves(tree, path=()):
    """(path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# Host spans
# ---------------------------------------------------------------------------


class Spans:
    """Host spans around the benchmark's calls into the program, kept in
    memory as (name, start, end) on ``time.perf_counter``; they name the
    device's idle gaps in a profiled stretch."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.records.append((name, t0, time.perf_counter()))

    def mean_s(self, name: str, since: float = 0.0):
        d = [t1 - t0 for n, t0, t1 in self.records if n == name and t0 >= since]
        return sum(d) / len(d) if d else None


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------

#: The marker kernel that opens and closes a profiled stretch on the card.
MARK = "spin_kernel"
_MARK_CYCLES = 1000
_DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start: float  # µs, on the trace's clock
    end: float
    stream: int


class Trace(NamedTuple):
    """A profiled stretch: its device operations, the benchmark's host
    spans inside it (moved onto the trace's clock), and the stretch's
    bounds (µs): from the start of the opening marker kernel to the end of
    the closing one."""

    ops: list
    spans: list     # (name, start, end)
    start: float
    end: float
    steps: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        stretch, in order."""
        iv = sorted((max(o.start, self.start), min(o.end, self.end)) for o in self.ops
                    if o.end > self.start and o.start < self.end)
        merged: list[list[float]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def launches(self) -> int:
        """Kernels and memsets in the stretch, the two markers left out."""
        return sum(1 for o in self.ops if o.cat in ("kernel", "gpu_memset")
                   and MARK not in o.name and self.start <= o.start < self.end)


def read_trace(path: str, steps: int, spans, t_mark: float) -> Trace:
    """Parse a Chrome trace exported by ``torch.profiler``.  The stretch
    runs from the first opening marker kernel to the last closing one (two
    of each are launched, so that one record lost leaves the bounds);
    ``t_mark``, the host time (``perf_counter``) at which the first opening
    marker was launched, carries the host spans onto the trace's clock."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = sorted((DeviceOp(e["name"], e["cat"], float(e["ts"]),
                           float(e["ts"]) + float(e.get("dur", 0.0)),
                           int(e.get("args", {}).get("stream", -1)))
                  for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS),
                 key=lambda o: o.start)
    work = [o for o in ops if MARK not in o.name]
    if not work:
        raise RuntimeError("the trace holds no device operation of the stretch")
    opening = [o for o in ops if MARK in o.name and o.end <= work[0].start]
    closing = [o for o in ops if MARK in o.name and o.start >= work[-1].end]
    start = opening[0].start if opening else work[0].start
    end = closing[-1].end if closing else work[-1].end
    offset = start - t_mark * 1e6
    moved = [(n, a * 1e6 + offset, b * 1e6 + offset) for n, a, b in spans]
    return Trace(ops, moved, start, end, steps)


@contextlib.contextmanager
def profiled(spans: Spans, steps: int, out: dict):
    """Profile the card over the enclosed stretch of ``steps`` steps, which
    marker kernels open and close, with the device's activity alone (no
    host-side op records, which would slow the host); leaves the parsed
    ``Trace`` in ``out['trace']``."""
    import tempfile

    import torch

    torch.cuda.synchronize()
    first = len(spans.records)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t_mark = time.perf_counter()
            torch.cuda._sleep(_MARK_CYCLES)
            torch.cuda._sleep(_MARK_CYCLES)
            yield
            torch.cuda._sleep(_MARK_CYCLES)
            torch.cuda._sleep(_MARK_CYCLES)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        out["trace"] = read_trace(path, steps, spans.records[first:], t_mark)
    finally:
        os.unlink(path)


def _matches(name: str, patterns) -> bool:
    """Whether ``name`` holds every substring of one of ``patterns``."""
    return any(all(part in name for part in p) for p in patterns)


def entry_device_s(trace: Trace, gemm, prepass) -> tuple[float, int]:
    """Device seconds and calls of one entry point in the stretch.

    A call is the entry's final kernel (its GEMM: a name that holds every
    substring of one tuple of ``gemm``) with the memsets and pre-pass
    kernels (``prepass``, the same form) that come right before it on its
    stream; any other operation in between starts a new call.
    """
    total, calls = 0.0, 0
    pending: dict[int, list] = {}
    for o in trace.ops:
        if not (o.end > trace.start and o.start < trace.end):
            continue
        p = pending.setdefault(o.stream, [])
        if o.cat == "kernel" and _matches(o.name, gemm):
            total += sum(x.end - x.start for x in p) + (o.end - o.start)
            calls += 1
            p.clear()
        elif o.cat == "gpu_memset" or (o.cat == "kernel" and _matches(o.name, prepass)):
            p.append(o)
        else:
            p.clear()
    return total * 1e-6, calls


def roofline_pct(readings: dict, trace, entry: str, gemm, prepass):
    """An entry point's share of its roofline over the stretch, in %: the
    least time its launches could take (``work.py``'s counts) over their
    device time.  Where the trace holds another number of calls than the
    cell's shapes give (a record the profiler lost), the bound is taken
    over the calls found, each at the mean call's bound; None where it
    holds fewer than half."""
    from perfbench import work

    launches = readings["work"]["entries"].get(entry)
    if trace is None or not launches:
        return None
    device_s, calls = entry_device_s(trace, gemm, prepass)
    expected = len(launches) * trace.steps
    if calls != expected:
        print(f"[metric] {entry}: {calls} calls in the trace, {expected} expected",
              file=sys.stderr)
    if calls * 2 < expected or device_s <= 0:
        return None
    bound = sum(work.bound_s(o, b) for o, b in launches) * trace.steps * calls / expected
    return 100.0 * bound / device_s


def short_name(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the benchmark's host span open at its start."""
    by_name: dict[str, float] = {}
    for o in trace.ops:
        if MARK in o.name:
            continue
        s, e = max(o.start, trace.start), min(o.end, trace.end)
        if e > s:
            by_name[short_name(o.name)] = by_name.get(short_name(o.name), 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # gaps between the stretch's first and last operations: the edges are
    # the stretch's own (the host issuing its first step onto an empty queue)
    work = [o for o in trace.ops if MARK not in o.name]
    busy = trace.busy_intervals()
    edges = [x for iv in busy for x in iv]
    gaps = [(edges[i], edges[i + 1]) for i in range(1, len(edges) - 1, 2)
            if edges[i + 1] > edges[i] and work[0].start <= edges[i] < work[-1].end]
    labelled = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        open_spans = [n for n, a, b in trace.spans if a <= s < b]
        labelled.append([open_spans[-1] if open_spans else "between spans", (e - s) * 1e-6])
    return {"device_ops": [[n, v] for n, v in top], "idle_gaps": labelled}


# ---------------------------------------------------------------------------
# The run's frame
# ---------------------------------------------------------------------------


def stage(what: str, t_start: float) -> None:
    """A set-up milestone on stderr: seconds since the process started."""
    print(f"[setup] {what} {time.perf_counter() - t_start:.3f} s", file=sys.stderr)


def require_cards(chips: int) -> None:
    """Exit without a result unless ``chips`` CUDA cards are present."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"perfbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules in this process's ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def card_info(chips: int) -> dict:
    """The card's name and power limit (watts, from ``nvidia-smi``)."""
    import torch

    info: dict[str, Any] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout.split()
        info["power_limit_w"] = float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


class Outcome(NamedTuple):
    """What a driver hands back: the end-to-end readings, the raw
    readings the per-layer readers take, the comparison's numbers as
    ``{name: (value, limit)}``, and the device's figures."""

    e2e: dict
    readings: dict
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Trace | None
    loaded: tuple = ()  # forbidden modules that the run's other processes found


def finish(cell: Cell, out: Outcome, trace: bool) -> int:
    """Print the result and return 0; or, where this process or one that
    the run started holds a forbidden module once the window has closed,
    name it on stderr and return 3 with no result."""
    found = sorted(set(forbidden_loaded()) | set(out.loaded))
    if found:
        print(f"perfbench: loaded {found}, which the benchmark must not load", file=sys.stderr)
        return 3
    emit(result_line(cell, out, trace, card_info(cell.chips)))
    return 0


def correct(checks: dict) -> bool:
    return all(v is not None and v <= lim for v, lim in checks.values())


def result_line(cell: Cell, out: Outcome, trace: bool, device: dict) -> dict:
    """The result object: end-to-end metrics with ``--trace 0``, the
    per-layer metrics the readers find with ``--trace 1``; the numbers
    compared come last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"], cell.base).read(out.readings, out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.e2e[quantity(m["name"], out.e2e)],
                                  "unit": m["unit"]}
    dev = dict(device, memory_peak_bytes=int(out.memory_peak_bytes))
    res = {"correct": correct(out.checks), "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.readings.get("busy_s", out.trace.busy_s)
        dev["window_s"] = out.readings.get("trace_window_s", out.trace.window_s)
        res["breakdown"] = breakdown(out.trace)
    res["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return res


def emit(res: dict) -> None:
    """Each number compared beside its limit as the last lines of stderr,
    then the result as the last line of stdout."""
    sys.stdout.flush()
    for k, c in res["checks"].items():
        print(f"[check] {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
