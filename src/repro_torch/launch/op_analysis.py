"""Op-level cost counter for the roofline methodology: the port's
counterpart of ``repro.launch.hlo_analysis``.

Eager torch emits no HLO: each aten op that reaches the dispatcher is a
kernel (or a view, which moves nothing).  So the counter is a light
``TorchDispatchMode`` that reads every dispatched op once, on whatever
device it runs: on ``meta`` (the dry run: shapes only, nothing allocated
or launched), on the CPU (the tests) or on the card (``chip_smoke.py``
phase 13 holds the two equal).  It counts:

  * ``ops``: every dispatched aten op, views included, except
    ``lift_fresh`` (a tensor literal's marker) and copies between devices
    (``transfers``: a host scalar moved to the card is a copy, not a
    kernel, and a CPU run has none);
  * FLOPs by operand dtype: 2·M·N·K for ``mm`` / ``addmm`` / ``bmm`` /
    ``baddbmm`` (``bf16``, ``f32``, ``int8``, ``int32``, ``f64``, …),
    2 · output elements · (C_in / groups · kernel area) for a convolution,
    and one ``elementwise`` FLOP per output element of every other op that
    is not a view or an allocation;
  * ``hbm_bytes``: Σ operands + results of every op that is not a view or
    an allocation (each tensor at most its storage: an expanded operand is
    read once).  In eager torch each such op is a kernel, so this is the
    traffic of the run, not an estimate after fusion;
  * a hand-written kernel called through ``core.cost_hook.opaque_product``
    (the card's ``int_matmul``) as one op: its product's FLOPs (``int8``,
    or ``int32`` if an operand is int32), its operands and result, and
    none of the aten ops inside its wrapper (output allocation, memset),
    so a meta trace and the card's run count alike;
  * the live bytes of every storage an op creates, by device, over time
    (a finalizer on each storage): ``peak`` replays that timeline, with a
    scale per storage where the dry run sizes one chip's share.  The
    storages of the gradients a step names through
    ``core.cost_hook.gradients`` are kept in ``gradients``; ``sid_of``
    finds a live tensor's storage in the timeline.

Collectives: an eager run on one device has none, so ``add_collective``
takes the dry run's analytic terms (``launch/dryrun.py``), each with the
link it crosses.  ``roofline_terms`` turns the counts into per-chip time
bounds from an H100 SXM5's published rates.
"""

from __future__ import annotations

import math
import weakref
from collections import Counter, defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import cost_hook

aten = torch.ops.aten

_MATMULS = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}
#: allocations: memory, but no traffic and no arithmetic
_ALLOCS = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
           aten.new_empty.default, aten.new_empty_strided.default}
_COPIES = {aten._to_copy.default, aten.copy_.default}

_BUCKETS = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
            torch.float64: "f64", torch.int8: "int8", torch.uint8: "int8",
            torch.int32: "int32", torch.int64: "int64"}


# ---------------------------------------------------------------------------
# Hardware constants: one NVIDIA H100 SXM5 80GB at its 700 W limit
# ---------------------------------------------------------------------------

#: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column, dense (no sparsity)
PEAK_BF16 = 989e12          # BF16 / FP16 tensor core, FLOP/s
PEAK_INT8 = 1979e12         # INT8 tensor core, OP/s
PEAK_TF32 = 495e12          # TF32 tensor core (the port keeps TF32 off)
PEAK_F32 = 67e12            # FP32, CUDA cores: the port's float32 GEMMs and elementwise
PEAK_F64 = 67e12            # FP64 tensor core
#: an int32 product runs as int8 digit GEMMs (``int_matmul`` route D):
#: at most 4 × 4 digit planes, so 1/16 of the int8 rate
PEAK_INT32 = PEAK_INT8 / 16
#: same datasheet: HBM3 3.35 TB/s; NVLink 4 900 GB/s a GPU in both
#: directions, 450 GB/s each way
HBM_BW = 3.35e12
NVLINK_BW = 450e9
#: DGX H100 datasheet: one ConnectX-7 400 Gb/s (NDR) port a GPU between
#: nodes, 50 GB/s each way
INTER_NODE_BW = 50e9
#: ``nvidia-smi --query-gpu=name,power.limit,memory.total
#: --format=csv,noheader`` on the card: "NVIDIA H100 80GB HBM3, 700.00 W,
#: 81559 MiB"
HBM_PER_CHIP = 81559 * 2 ** 20

LINK_BW = {"nvlink": NVLINK_BW, "inter-node": INTER_NODE_BW}
_RATE = {"bf16": PEAK_BF16, "f16": PEAK_BF16, "int8": PEAK_INT8, "int32": PEAK_INT32,
         "f32": PEAK_F32, "f64": PEAK_F64, "elementwise": PEAK_F32}


@dataclass
class OpCosts:
    """What a traced region did, in ``HloCosts``' fields and more."""

    flops: dict = field(default_factory=lambda: defaultdict(float))
    hbm_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=lambda: defaultdict(float))
    collective_counts: dict = field(default_factory=lambda: defaultdict(float))
    #: wire bytes by the link each collective crosses ("nvlink", "inter-node")
    collective_link_bytes: dict = field(default_factory=lambda: defaultdict(float))
    ops: int = 0
    transfers: int = 0
    #: dispatched ops by name (what tells two traces apart)
    by_op: Counter = field(default_factory=Counter)
    #: each ``opaque_product``: (name, a's shape, b's shape, FLOP bucket)
    products: list = field(default_factory=list)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def summary(self) -> dict:
        """The counts two traces of one step must share exactly."""
        return {"ops": self.ops, "flops": {k: v for k, v in sorted(self.flops.items()) if v},
                "hbm_bytes": self.hbm_bytes}


def _tensors(tree):
    """The tensors of an op's arguments or results (one list level deep:
    aten's tensor lists)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, (list, tuple)):
                yield from (y for y in x if isinstance(y, torch.Tensor))
    elif isinstance(tree, dict):
        yield from _tensors(list(tree.values()))


def _nbytes(t: torch.Tensor) -> int:
    n = t.numel() * t.element_size()
    if n and not t.is_contiguous():  # an expanded operand is read once
        n = min(n, t.untyped_storage().nbytes())
    return n


def _bucket(dtype) -> str:
    return _BUCKETS.get(dtype, str(dtype).removeprefix("torch."))


def _matmul_flops(func, args) -> float:
    a, b = (args[1], args[2]) if func in (aten.addmm.default, aten.baddbmm.default) \
        else (args[0], args[1])
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _conv_flops(args, out) -> float:
    w = args[1]  # (C_out, C_in / groups, *kernel)
    return 2.0 * out.numel() * math.prod(w.shape[1:])


class OpAnalyzer(TorchDispatchMode):
    """``with OpAnalyzer() as an: step(...)`` → ``an.costs`` (an
    ``OpCosts``) and ``an.peak(...)``, the live-storage timeline's peak."""

    def __init__(self):
        super().__init__()
        self.costs = OpCosts()
        self._paused = 0
        self._live: dict[int, int] = {}       # storage id → timeline id
        self._size: list[int] = []            # timeline id → bytes
        self._device: list[str] = []          # timeline id → device type
        self.shapes: list[tuple] = []         # timeline id → its creator's shape
        self._events: list[int] = []          # +id + 1: created, −id − 1: freed
        self._closed = False
        #: timeline ids of the gradients ``cost_hook.gradients`` named
        #: (None for one whose storage was not created in the region)
        self.gradients: list = []

    # -- the timeline -----------------------------------------------------
    def _free(self, sid: int, key: int) -> None:
        if self._live.get(key) == sid:
            del self._live[key]
        if not self._closed:
            self._events.append(-sid - 1)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        sid = len(self._size)
        self._live[key] = sid
        self._size.append(st.nbytes())
        self._device.append(t.device.type)
        self.shapes.append(tuple(t.shape))
        self._events.append(sid + 1)
        weakref.finalize(st, self._free, sid, key)

    def sid_of(self, t: torch.Tensor) -> int | None:
        """The timeline id of ``t``'s storage, if it was created in the
        traced region and is still live."""
        return self._live.get(t.untyped_storage()._cdata)

    def size(self, sid: int) -> int:
        return self._size[sid]

    def peak(self, device: str | None = None, scale=None) -> float:
        """Peak live bytes of the storages created in the traced region (on
        ``device``, a device type; default: every device but the CPU, or the
        CPU when nothing else was traced), each times ``scale(id)``."""
        if device is None:
            device = next((d for d in self._device if d != "cpu"), "cpu")
        live = best = 0.0
        for ev in self._events:
            sid = ev - 1 if ev > 0 else -ev - 1
            if self._device[sid] != device:
                continue
            b = self._size[sid] * (scale(sid) if scale is not None else 1.0)
            live += b if ev > 0 else -b
            best = max(best, live)
        return best

    # -- the mode ---------------------------------------------------------
    def __enter__(self):
        cost_hook.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        self._closed = True
        cost_hook.pop(self)
        return super().__exit__(*exc)

    @contextmanager
    def paused(self):
        """Dispatch inside without counting (a kernel's wrapper)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func is aten.lift_fresh.default:
            return out
        c = self.costs
        outs = list(_tensors(out))
        if func in _COPIES:
            src = args[1] if func is aten.copy_.default else args[0]
            if outs and src.device != outs[0].device:
                c.transfers += 1
                self._track_new(func, outs)
                return out
        c.ops += 1
        c.by_op[func.__name__] += 1
        if func.is_view:
            return out
        self._track_new(func, outs)
        if func in _ALLOCS:
            return out
        if func in _MATMULS:
            operand = args[1] if func in (aten.addmm.default, aten.baddbmm.default) else args[0]
            c.flops[_bucket(operand.dtype)] += _matmul_flops(func, args)
        elif func is aten.convolution.default:
            c.flops[_bucket(args[0].dtype)] += _conv_flops(args, outs[0])
        else:
            c.flops["elementwise"] += sum(t.numel() for t in outs)
        c.hbm_bytes += sum(_nbytes(t) for t in _tensors(args)) + \
            sum(_nbytes(t) for t in _tensors(kwargs)) + sum(_nbytes(t) for t in outs)
        return out

    def _track_new(self, func, outs) -> None:
        returns = func._schema.returns
        for i, t in enumerate(outs):
            aliased = i < len(returns) and returns[i].alias_info is not None
            if not aliased:
                self._track(t)

    # -- what core.cost_hook tells it -------------------------------------
    def mark_gradients(self, tensors) -> None:
        self.gradients = [self.sid_of(t) for t in tensors]

    def record_product(self, name: str, a: torch.Tensor, b: torch.Tensor,
                       out: torch.Tensor) -> None:
        """One call of a hand-written GEMM kernel: ``a (…, K) @ b (K, N)``."""
        c = self.costs
        bucket = "int32" if torch.int32 in (a.dtype, b.dtype) else _bucket(a.dtype)
        c.ops += 1
        c.by_op[name] += 1
        c.flops[bucket] += 2.0 * a.numel() * b.shape[-1]
        c.hbm_bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
        c.products.append((name, tuple(a.shape), tuple(b.shape), bucket))
        self._track(out)

    def add_collective(self, kind: str, wire_bytes: float, link: str | None,
                       count: float = 1.0) -> None:
        """An analytic collective: ``wire_bytes`` a chip sends over ``link``."""
        if link is None or not wire_bytes:
            return
        c = self.costs
        c.collective_bytes[kind] += wire_bytes
        c.collective_counts[kind] += count
        c.collective_link_bytes[link] += wire_bytes


def roofline_terms(costs: OpCosts, chips: int = 1) -> dict:
    """Per-chip time lower bounds, in seconds.  The trace counts the whole
    step, so FLOPs and HBM bytes are divided evenly over ``chips`` (an
    assumption: it holds where every chip runs the same shard of the
    work); the collective terms are already per chip."""
    compute_s = sum(v / _RATE.get(k, PEAK_F32) for k, v in costs.flops.items()) / chips
    memory_s = costs.hbm_bytes / chips / HBM_BW
    collective_s = sum(v / LINK_BW[link] for link, v in costs.collective_link_bytes.items())
    dominant = max([("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)], key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "flops_by_dtype": dict(costs.flops),
        "hbm_bytes": costs.hbm_bytes,
        "collective_bytes": dict(costs.collective_bytes),
        "collective_counts": dict(costs.collective_counts),
        "collective_link_bytes": dict(costs.collective_link_bytes),
        "collectives": "analytic",
    }
