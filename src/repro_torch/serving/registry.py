"""Multi-model registry: FrozenModels compiled once, served by id (port of
``repro.serving.registry``).

  * ``register`` / ``load`` compile a FrozenModel into an ExecutionPlan
    under a caller-chosen **model id**, with per-model ``EngineStats``;
  * ``swap`` is the **hot-swap**: a new checkpoint replaces the plan under
    a stable id.  The plan is compiled outside the table lock, then the
    entry flips atomically, so a concurrent ``get`` / ``submit`` sees the
    old or the new plan, never a torn one.  Stats and the SLO survive the
    swap; ``version`` counts swaps;
  * ``evict`` frees a model; its in-flight batches still resolve because
    schedulers hold the entry (and thus the plan) by reference;
  * **padding buffers are shared**: models with the same per-sample input
    shape pad partial batches from one read-only zero buffer.

On CUDA the entry flips only after the new plan's weights are on the
card: ``compile_plan`` copies them from pageable host memory with a
blocking ``.to(device)``, so a batch dispatched on the new plan never
reads a weight still in flight.

``from_manifest`` builds a registry from an on-disk ``FLEET.json``
(``infer.export.save_fleet_manifest``).  ``metrics=`` makes the registry
scrapeable (see ``ModelRegistry``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.infer.export import FrozenModel, load_fleet_manifest, load_frozen
from repro_torch.infer.plan import ExecutionPlan, compile_plan
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.serving.stats import EngineStats, Slo


@dataclass
class ModelEntry:
    """One served model: compiled plan + identity + live counters.

    ``plan`` is replaced wholesale on hot-swap (never mutated), so a
    scheduler that read the entry keeps a self-consistent plan for the
    batch it is assembling even while a swap lands.  ``slo`` belongs to
    the long-lived model id, so hot-swaps keep it.
    """

    model_id: str
    plan: ExecutionPlan
    version: int = 0
    stats: EngineStats = field(default_factory=EngineStats)
    slo: Slo | None = None

    @property
    def input_shape(self) -> tuple[int, ...]:
        return tuple(self.plan.input_shape)


class ModelRegistry:
    """Thread-safe model-id → ModelEntry table with shared pad buffers.

    ``device``, ``backend`` and ``operand_dtype`` are passed to
    ``compile_plan`` for every model (``device`` defaults to CUDA, as
    every entry point of the port does).

    Pass ``metrics=`` (a shared ``obs.MetricRegistry``) and the registry
    becomes scrapeable: each model's ``EngineStats`` registers as
    ``serve_*_total{model=<id>}`` children of the shared families, and
    lifecycle events surface as ``serve_model_swaps_total`` /
    ``serve_model_version`` / ``serve_model_events_total``.
    """

    def __init__(self, *, device=DEFAULT_DEVICE, backend: str = "auto",
                 operand_dtype: str = "auto",
                 metrics: MetricRegistry | None = None):
        self.device = device
        self.backend = backend
        self.operand_dtype = operand_dtype
        self.metrics = metrics
        self._lock = threading.RLock()
        self._entries: dict[str, ModelEntry] = {}
        self._pads: dict[tuple[int, ...], np.ndarray] = {}
        if metrics is not None:
            self._swaps = metrics.counter(
                "serve_model_swaps_total",
                "checkpoint hot-swaps under a stable model id",
                labels=("model",),
            )
            self._version = metrics.gauge(
                "serve_model_version",
                "version of the checkpoint currently answering a model id",
                labels=("model",),
            )
            self._events = metrics.counter(
                "serve_model_events_total",
                "model lifecycle events (register / swap / evict)",
                labels=("event", "model"),
            )

    def _make_stats(self, model_id: str) -> EngineStats:
        if self.metrics is None:
            return EngineStats()
        return EngineStats(registry=self.metrics,
                           labels={"model": model_id})

    def _record_event(self, event: str, entry: ModelEntry) -> None:
        if self.metrics is not None:
            self._events.labels(event=event, model=entry.model_id).inc()
            self._version.labels(model=entry.model_id).set(entry.version)

    def _compile(self, fm: FrozenModel, backend, operand_dtype) -> ExecutionPlan:
        return compile_plan(fm, device=self.device,
                            backend=backend or self.backend,
                            operand_dtype=operand_dtype or self.operand_dtype)

    # ---- lifecycle --------------------------------------------------------

    def register(self, model_id: str, fm: FrozenModel, *,
                 backend: str | None = None,
                 operand_dtype: str | None = None,
                 slo: Slo | None = None) -> ModelEntry:
        """Compile ``fm`` and serve it as ``model_id`` (id must be free)."""
        if not model_id:
            raise ValueError("model_id must be non-empty")
        plan = self._compile(fm, backend, operand_dtype)
        with self._lock:
            if model_id in self._entries:
                raise ValueError(
                    f"model id {model_id!r} already registered — "
                    f"use swap() to hot-swap its checkpoint"
                )
            entry = ModelEntry(model_id=model_id, plan=plan,
                               stats=self._make_stats(model_id), slo=slo)
            self._entries[model_id] = entry
            self._pad_for(plan.input_shape)
        self._record_event("register", entry)
        return entry

    def load(self, model_id: str, model_dir: str, *,
             step: int | None = None,
             backend: str | None = None,
             slo: Slo | None = None) -> ModelEntry:
        """``load_frozen`` + ``register`` in one call."""
        return self.register(model_id, load_frozen(model_dir, step=step),
                             backend=backend, slo=slo)

    def set_slo(self, model_id: str, slo: Slo | None) -> ModelEntry:
        """Attach (or clear) a model's serving objective after load; engines
        pick it up on the next delivered batch."""
        with self._lock:
            entry = self._require(model_id)
            entry.slo = slo
        return entry

    def swap(self, model_id: str, fm: FrozenModel, *,
             backend: str | None = None,
             operand_dtype: str | None = None) -> ModelEntry:
        """Hot-swap ``model_id``'s checkpoint under its stable id.

        Compiles the incoming model (weights on the device) before taking
        the lock, so submitters never wait behind a compile, then flips
        the plan and bumps ``version``.  Stats carry over.
        """
        plan = self._compile(fm, backend, operand_dtype)
        with self._lock:
            entry = self._require(model_id)
            if tuple(plan.input_shape) != entry.input_shape:
                raise ValueError(
                    f"hot-swap for {model_id!r} changes input shape "
                    f"{entry.input_shape} -> {tuple(plan.input_shape)}"
                )
            entry.plan = plan
            entry.version += 1
            self._pad_for(plan.input_shape)
        if self.metrics is not None:
            self._swaps.labels(model=model_id).inc()
        self._record_event("swap", entry)
        return entry

    def evict(self, model_id: str) -> None:
        with self._lock:
            entry = self._require(model_id)
            del self._entries[model_id]
        self._record_event("evict", entry)

    # ---- lookup -----------------------------------------------------------

    def get(self, model_id: str) -> ModelEntry:
        with self._lock:
            return self._require(model_id)

    def ids(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def pad_buffer(self, input_shape) -> np.ndarray:
        """The shared zero buffer for one per-sample input shape."""
        with self._lock:
            return self._pad_for(input_shape)

    def snapshot(self) -> dict:
        """Per-model JSON-ready stats view (id → version + EngineStats)."""
        with self._lock:
            entries = list(self._entries.values())
        return {
            e.model_id: {"version": e.version,
                         "model": e.plan.name,
                         "slo_ms": e.slo.deadline_ms if e.slo else None,
                         **e.stats.snapshot()}
            for e in entries
        }

    # ---- internals --------------------------------------------------------

    def _require(self, model_id: str) -> ModelEntry:
        try:
            return self._entries[model_id]
        except KeyError:
            raise KeyError(
                f"unknown model id {model_id!r}; registered: "
                f"{sorted(self._entries)}"
            ) from None

    def _pad_for(self, input_shape) -> np.ndarray:
        shape = tuple(int(d) for d in input_shape)
        pad = self._pads.get(shape)
        if pad is None:
            pad = np.zeros(shape, np.int32)
            pad.setflags(write=False)  # shared across models: keep immutable
            self._pads[shape] = pad
        return pad

    @classmethod
    def from_manifest(cls, root: str, *, device=DEFAULT_DEVICE,
                      backend: str = "auto",
                      operand_dtype: str = "auto",
                      metrics: MetricRegistry | None = None,
                      ) -> "ModelRegistry":
        """Build a registry from an on-disk ``FLEET.json`` directory."""
        manifest = load_fleet_manifest(root)
        reg = cls(device=device, backend=backend, operand_dtype=operand_dtype,
                  metrics=metrics)
        for model_id, model_dir in sorted(manifest["models"].items()):
            reg.load(model_id, model_dir)
        return reg
