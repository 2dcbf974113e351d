"""Training-health rule engine: the *actionable* layer over telemetry
(port of ``repro.obs.health``; pure Python, so the port keeps its own
copy).

``repro_torch.obs.telemetry`` measures the integer envelopes NITRO-D training
must stay inside (bit occupancy, saturation, dead units, optimiser
scalars) — this module *watches* them.  An integer-only run that starts
saturating its int32 accumulators, or whose blocks are dying, fails
silently: the step keeps executing, the loss keeps printing, and the
budget burns (NITI, Wang et al. 2020, documents exactly this overflow
failure mode).  ``HealthMonitor`` turns the per-step telemetry records
into **alerts** the moment the trend is visible, online in the
``launch/train.py`` loop or offline over any ``metrics.jsonl``
(``scan_jsonl`` — the ``obs_top --once`` post-mortem path).

Design:

  * a **rule** holds per-signal sliding windows (windows advance per
    *sampled* step — the unit the telemetry cadence actually delivers)
    and fires **edge-triggered** alerts with hysteresis: a rule that
    fired stays *active* (visible in ``active_alerts()`` / the
    dashboard) without re-firing every step, and re-arms only when its
    clear condition — strictly below the fire condition — holds, so a
    signal oscillating around the threshold cannot ring the bell once
    per sample;
  * alerts carry a severity from :data:`SEVERITIES`; a rule whose
    condition *escalates* (warning → critical) while active fires
    again at the higher severity;
  * **sinks** are plain callables ``sink(alert)`` (see ``print_sink`` /
    ``jsonl_sink``); with a ``MetricRegistry`` attached the monitor
    additionally emits ``obs_alerts_total{rule,severity}`` counters,
    per-tensor ``obs_headroom_bits{layer,tensor}`` gauges (bits left
    before int32 overflow — the early-warning signal), and the
    ``dp_grad_fits_int16`` gauge (limb sufficiency of the compressed
    data-parallel reducer).

The rule catalogue (signal, window, threshold, rationale) is documented
in ``docs/OBSERVABILITY.md`` (the JAX package's; the rules here are the
same).  None of this touches the training step: the monitor is a pure
consumer of the host-side records, so the telemetry-invariance guarantee
(a bitwise-identical trajectory) is untouched by construction.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable

from repro_torch.obs.metrics import MetricRegistry

#: Alert severities, least to most severe.
SEVERITIES = ("info", "warning", "critical")

#: int32 magnitude bits — headroom is measured against this.
INT32_BITS = 31

#: Tensor-record keys a telemetry layer row may carry.
TENSOR_KEYS = ("weight", "grad", "z_star", "act")


def _severity_rank(severity: str) -> int:
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(
            f"unknown severity {severity!r}; expected one of {SEVERITIES}"
        ) from None


@dataclass(frozen=True)
class Alert:
    """One fired health alert (immutable, JSON-ready via ``to_json``)."""

    rule: str
    severity: str
    step: int
    layer: str      # "" for run-wide signals (optimiser scalars, DP)
    signal: str     # e.g. "act.sat_int8_frac"
    value: float
    threshold: float
    message: str

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "severity": self.severity, "step": self.step,
            "layer": self.layer, "signal": self.signal, "value": self.value,
            "threshold": self.threshold, "message": self.message,
        }

    def format(self) -> str:
        where = f" {self.layer}" if self.layer else ""
        return (f"[{self.severity.upper()}] step {self.step}{where} "
                f"{self.rule}: {self.message}")


# ---------------------------------------------------------------------------
# Rule base: per-key windows + edge-triggered hysteresis
# ---------------------------------------------------------------------------


class Rule:
    """One health rule: windowed state per signal key, hysteresis state.

    Subclasses implement ``observe(step, rows)`` returning newly-fired
    alerts; ``rows`` is one sampled step's telemetry, keyed by layer.
    The base class owns the window buffers (``push``) and the
    active-alert state machine (``update``): a key transitions
    inactive → active when its fire condition holds (alert emitted),
    stays active silently while neither fires-higher nor clears, emits
    again only on severity escalation, and re-arms when the rule's
    clear condition holds.
    """

    name = "rule"
    severity = "warning"

    def __init__(self, *, window: int = 1):
        if window < 1:
            raise ValueError(f"{self.name}: window must be >= 1")
        self.window = window
        self._windows: dict[tuple, deque] = {}
        self.active: dict[tuple, Alert] = {}

    def push(self, key: tuple, value: float) -> deque:
        """Append one sample to ``key``'s window; returns the window."""
        win = self._windows.get(key)
        if win is None:
            win = self._windows[key] = deque(maxlen=self.window)
        win.append(value)
        return win

    def update(self, key: tuple, *, firing: bool, cleared: bool,
               alert: Callable[[], Alert]) -> Alert | None:
        """Advance one key's hysteresis state; returns a new alert or None.

        ``firing``/``cleared`` are this step's fire/clear conditions
        (clear must be *stricter than* not-firing for real hysteresis).
        ``alert`` is called lazily, only when something is emitted.
        """
        current = self.active.get(key)
        if current is None:
            if firing:
                fired = alert()
                self.active[key] = fired
                return fired
            return None
        if firing:
            fired = alert()
            if _severity_rank(fired.severity) > _severity_rank(
                    current.severity):
                self.active[key] = fired  # escalation re-fires
                return fired
            return None  # still firing at same severity: stay silent
        if cleared:
            del self.active[key]
        return None

    def observe(self, step: int, rows: dict[str, dict]) -> list[Alert]:
        raise NotImplementedError


def _is_monotone_growth(vals: Iterable[float]) -> bool:
    """Nondecreasing over the full window with a strictly positive net."""
    vals = list(vals)
    return (all(b >= a for a, b in zip(vals, vals[1:]))
            and vals[-1] > vals[0])


class SaturationTrendRule(Rule):
    """Saturation-fraction watchdog with a rising-trend early warning.

    Watches one saturation field (``sat_int8_frac`` or
    ``sat_int32_frac``) of the given tensors on every layer.  Fires when
    the latest value exceeds ``fire``, **or** — the trend detector —
    when the window is full, the values grew monotonically across it,
    and the latest already exceeds ``trend_fire`` (default ``fire/2``):
    a signal climbing steadily through half the budget is an overflow
    in the making even before it crosses the hard line.  Clears only at
    or below ``clear``.
    """

    def __init__(self, *, field: str = "sat_int8_frac",
                 tensors: tuple[str, ...] = ("act", "z_star"),
                 fire: float = 0.25, clear: float | None = None,
                 trend_fire: float | None = None,
                 window: int = 8, severity: str = "warning",
                 name: str | None = None):
        super().__init__(window=window)
        _severity_rank(severity)
        self.field = field
        self.tensors = tuple(tensors)
        self.fire = fire
        self.clear = fire / 2 if clear is None else clear
        self.trend_fire = fire / 2 if trend_fire is None else trend_fire
        self.severity = severity
        self.name = name or f"saturation[{field}]"

    def observe(self, step: int, rows: dict[str, dict]) -> list[Alert]:
        fired = []
        for layer, row in rows.items():
            for tensor in self.tensors:
                rec = row.get(tensor)
                if not isinstance(rec, dict) or self.field not in rec:
                    continue
                key = (layer, tensor)
                win = self.push(key, float(rec[self.field]))
                latest = win[-1]
                over = latest > self.fire
                trending = (len(win) == self.window
                            and _is_monotone_growth(win)
                            and latest > self.trend_fire)

                def alert(latest=latest, layer=layer, tensor=tensor,
                          over=over):
                    kind = ("above threshold" if over
                            else f"rising monotonically over the last "
                                 f"{self.window} samples")
                    return Alert(
                        rule=self.name, severity=self.severity, step=step,
                        layer=layer, signal=f"{tensor}.{self.field}",
                        value=latest, threshold=self.fire,
                        message=(f"{tensor} {self.field} = {latest:.4f} "
                                 f"{kind} (fire > {self.fire:g}, "
                                 f"clear <= {self.clear:g})"),
                    )

                out = self.update(key, firing=over or trending,
                                  cleared=latest <= self.clear, alert=alert)
                if out is not None:
                    fired.append(out)
        return fired


class HeadroomRule(Rule):
    """Bit-occupancy overflow early warning: int32 headroom in bits.

    ``headroom = 31 − msb`` of a tensor's occupied bit envelope — the
    number of doublings left before the int32 carrying dtype overflows.
    Warning at ``<= warn_bits``, escalating to critical at
    ``<= critical_bits`` (an escalation re-fires); clears only at
    ``>= clear_bits`` so a tensor breathing around the boundary does
    not flap.  The per-tensor gauge (``obs_headroom_bits``) is set by
    the monitor for every tensor every step regardless of alerts.
    """

    name = "headroom"

    def __init__(self, *, tensors: tuple[str, ...] = ("grad", "weight",
                                                      "z_star", "act"),
                 warn_bits: int = 4, critical_bits: int = 2,
                 clear_bits: int = 6):
        super().__init__(window=1)
        if not critical_bits <= warn_bits <= clear_bits:
            raise ValueError("need critical_bits <= warn_bits <= clear_bits")
        self.tensors = tuple(tensors)
        self.warn_bits = warn_bits
        self.critical_bits = critical_bits
        self.clear_bits = clear_bits

    def observe(self, step: int, rows: dict[str, dict]) -> list[Alert]:
        fired = []
        for layer, row in rows.items():
            for tensor in self.tensors:
                rec = row.get(tensor)
                if not isinstance(rec, dict) or "msb" not in rec:
                    continue
                headroom = INT32_BITS - int(rec["msb"])
                key = (layer, tensor)
                severity = ("critical" if headroom <= self.critical_bits
                            else "warning")
                threshold = (self.critical_bits
                             if severity == "critical" else self.warn_bits)

                def alert(headroom=headroom, layer=layer, tensor=tensor,
                          severity=severity, threshold=threshold, rec=rec):
                    return Alert(
                        rule=self.name, severity=severity, step=step,
                        layer=layer, signal=f"{tensor}.headroom_bits",
                        value=float(headroom), threshold=float(threshold),
                        message=(f"{tensor} has {headroom} bits of int32 "
                                 f"headroom (msb {rec['msb']}/{INT32_BITS}, "
                                 f"max|x| {rec.get('max_abs')}) — "
                                 f"{'overflow imminent' if severity == 'critical' else 'approaching overflow'}"),
                    )

                out = self.update(key, firing=headroom <= self.warn_bits,
                                  cleared=headroom >= self.clear_bits,
                                  alert=alert)
                if out is not None:
                    fired.append(out)
        return fired


class DeadUnitGrowthRule(Rule):
    """Monotone dead-unit growth (dying-block detector).

    Watches each block's ``dead_frac`` (pre-activations in NITRO-ReLU's
    zero-derivative segments).  Fires a warning when the fraction grew
    monotonically across a full window by at least ``min_growth`` —
    the trajectory signature of a block drifting dead — escalating to
    critical once the fraction passes ``ceiling`` (the block is
    effectively untrainable).  Clears when growth has stopped *and*
    the fraction is back under ``ceiling``.
    """

    name = "dead_units"

    def __init__(self, *, window: int = 6, min_growth: float = 0.05,
                 ceiling: float = 0.9):
        super().__init__(window=window)
        self.min_growth = min_growth
        self.ceiling = ceiling

    def observe(self, step: int, rows: dict[str, dict]) -> list[Alert]:
        fired = []
        for layer, row in rows.items():
            if "dead_frac" not in row:
                continue
            key = (layer,)
            win = self.push(key, float(row["dead_frac"]))
            latest = win[-1]
            growing = (len(win) == self.window
                       and _is_monotone_growth(win)
                       and latest - win[0] >= self.min_growth)
            ceiled = latest >= self.ceiling
            severity = "critical" if ceiled else "warning"

            def alert(latest=latest, layer=layer, win=win, ceiled=ceiled,
                      severity=severity):
                if ceiled:
                    msg = (f"dead_frac = {latest:.3f} >= ceiling "
                           f"{self.ceiling:g} — block effectively dead")
                else:
                    msg = (f"dead_frac grew {win[0]:.3f} -> {latest:.3f} "
                           f"monotonically over {self.window} samples "
                           f"(>= {self.min_growth:g} net growth)")
                return Alert(
                    rule=self.name, severity=severity, step=step,
                    layer=layer, signal="dead_frac", value=latest,
                    threshold=self.ceiling if ceiled else self.min_growth,
                    message=msg,
                )

            out = self.update(key, firing=growing or ceiled,
                              cleared=not growing and not ceiled,
                              alert=alert)
            if out is not None:
                fired.append(out)
        return fired


class OptimizerStallRule(Rule):
    """Optimiser-scalar stall: the ÷3-on-plateau schedule ran away.

    The IntegerSGD scalars divide the update (``eta_inv``) and the
    gradient (``gamma_inv``); once one exceeds ``max_scalar`` the
    integer floor-division quantises most updates to zero — training
    silently stalls while steps keep executing.  Edge-triggered per
    scalar; the schedule is monotone, so a fired alert effectively
    stays active for the rest of the run (clear exists for symmetry
    and for restored-from-checkpoint runs).
    """

    name = "opt_scalar_stall"

    def __init__(self, *, max_scalar: int = 1 << 20,
                 fields: tuple[str, ...] = ("eta_inv_lr", "eta_inv_fw",
                                            "gamma_inv_lr", "gamma_inv_fw")):
        super().__init__(window=1)
        self.max_scalar = max_scalar
        self.fields = tuple(fields)

    def observe(self, step: int, rows: dict[str, dict]) -> list[Alert]:
        opt = rows.get("_opt")
        if not opt:
            return []
        fired = []
        for f in self.fields:
            if f not in opt:
                continue
            value = int(opt[f])
            key = (f,)

            def alert(value=value, f=f):
                return Alert(
                    rule=self.name, severity="warning", step=step,
                    layer="", signal=f"opt.{f}", value=float(value),
                    threshold=float(self.max_scalar),
                    message=(f"{f} = {value} >= {self.max_scalar} — "
                             f"integer updates quantise to zero "
                             f"(effective step size underflow)"),
                )

            out = self.update(key, firing=value >= self.max_scalar,
                              cleared=value < self.max_scalar, alert=alert)
            if out is not None:
                fired.append(out)
        return fired


class DpCompressFitRule(Rule):
    """Compressed-reducer limb sufficiency (data-parallel runs only).

    ``parallel.dp`` records ``grad_fits_int16`` — whether every
    shard-local gradient element round-trips the 2-limb (int16) wire
    encoding.  A 0 means a ``dp_reduce="compress"`` run at
    ``num_limbs=2`` would be *lossy*: fire a warning so the operator
    sees it instead of assuming it.
    """

    name = "dp_compress_fit"

    def __init__(self):
        super().__init__(window=1)

    def observe(self, step: int, rows: dict[str, dict]) -> list[Alert]:
        dp = rows.get("_dp")
        if not dp or "grad_fits_int16" not in dp:
            return []
        fits = int(dp["grad_fits_int16"])
        key = ("grad_fits_int16",)

        def alert():
            return Alert(
                rule=self.name, severity="warning", step=step, layer="",
                signal="dp.grad_fits_int16", value=float(fits),
                threshold=1.0,
                message=("shard-local gradients no longer fit int16 "
                         "limbs — a 2-limb compressed all-reduce would "
                         "be lossy (use num_limbs>=3 or psum/ring)"),
            )

        out = self.update(key, firing=fits == 0, cleared=fits == 1,
                          alert=alert)
        return [out] if out is not None else []


def default_rules() -> list[Rule]:
    """The standing rule set ``launch/train.py`` arms (catalogued in the
    JAX package's docs/OBSERVABILITY.md — thresholds there, rationale
    here in code)."""
    return [
        # any int32-tail occupancy is one doubling from overflow: critical
        SaturationTrendRule(field="sat_int32_frac",
                            tensors=("weight", "grad", "z_star", "act"),
                            fire=0.0, clear=0.0, trend_fire=0.0,
                            window=4, severity="critical",
                            name="saturation[int32]"),
        # int8 activation-range pressure: warn at 25%, trend-warn from 12.5%
        SaturationTrendRule(field="sat_int8_frac", tensors=("act",),
                            fire=0.25, window=8, severity="warning",
                            name="saturation[int8]"),
        HeadroomRule(),
        DeadUnitGrowthRule(),
        OptimizerStallRule(),
        DpCompressFitRule(),
    ]


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------


def print_sink(alert: Alert) -> None:
    """Print one alert line (the train CLI's default sink)."""
    print(f"[alert] {alert.format()}")


def jsonl_sink(path: str) -> Callable[[Alert], None]:
    """A sink appending one JSON line per alert to ``path``."""

    def sink(alert: Alert) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(alert.to_json(), sort_keys=True) + "\n")

    return sink


# ---------------------------------------------------------------------------
# Monitor
# ---------------------------------------------------------------------------


def group_steps(records: Iterable[dict]) -> list[tuple[int, dict[str, dict]]]:
    """Flat telemetry rows → ``[(step, {layer: row})]`` in file order.

    Rows for one step are contiguous in ``metrics.jsonl`` (the writer
    appends one sampled step at a time), so grouping is a single pass;
    out-of-order steps simply start a new group — the monitor never
    reorders history behind the run's back.
    """
    grouped: list[tuple[int, dict[str, dict]]] = []
    for rec in records:
        step = int(rec.get("step", -1))
        layer = str(rec.get("layer", ""))
        if not grouped or grouped[-1][0] != step:
            grouped.append((step, {}))
        grouped[-1][1][layer] = rec
    return grouped


class HealthMonitor:
    """Runs a rule set over telemetry records; fans alerts out to sinks.

    Online: call ``observe_records(records)`` with each sampled step's
    rows (what ``launch/train.py`` does).  Offline: ``scan_jsonl`` over
    a finished run's ``metrics.jsonl``.  With ``registry=`` attached the
    monitor also maintains the health gauges/counters (see module
    docstring) so a live scrape shows the same state the dashboard
    renders.
    """

    def __init__(self, rules: Iterable[Rule] | None = None, *,
                 registry: MetricRegistry | None = None,
                 sinks: Iterable[Callable[[Alert], None]] = ()):
        self.rules = list(rules) if rules is not None else default_rules()
        self.sinks = list(sinks)
        self.registry = registry
        self.alerts: list[Alert] = []
        self.steps_observed = 0
        if registry is not None:
            self._alerts_total = registry.counter(
                "obs_alerts_total", "health alerts fired",
                labels=("rule", "severity"))
            self._active_gauge = registry.gauge(
                "obs_alerts_active", "health alerts currently active",
                labels=("rule",))
            self._headroom_gauge = registry.gauge(
                "obs_headroom_bits",
                "bits left before int32 overflow, per tensor",
                labels=("layer", "tensor"))
            self._dp_fits_gauge = registry.gauge(
                "dp_grad_fits_int16",
                "1 when every shard-local gradient fits 2 int8 limbs")
        else:
            self._alerts_total = None
            self._active_gauge = None
            self._headroom_gauge = None
            self._dp_fits_gauge = None

    # ---- feeding ----------------------------------------------------------

    def observe_records(self, records: Iterable[dict]) -> list[Alert]:
        """Feed telemetry rows (one or many steps); returns new alerts."""
        fired: list[Alert] = []
        for step, rows in group_steps(records):
            fired.extend(self._observe_step(step, rows))
        return fired

    def _observe_step(self, step: int, rows: dict[str, dict]) -> list[Alert]:
        self.steps_observed += 1
        self._update_gauges(rows)
        fired: list[Alert] = []
        for rule in self.rules:
            for alert in rule.observe(step, rows):
                fired.append(alert)
                self.alerts.append(alert)
                if self._alerts_total is not None:
                    self._alerts_total.labels(
                        rule=alert.rule, severity=alert.severity).inc()
                for sink in self.sinks:
                    sink(alert)
            if self._active_gauge is not None:
                self._active_gauge.labels(rule=rule.name).set(
                    len(rule.active))
        return fired

    def _update_gauges(self, rows: dict[str, dict]) -> None:
        if self._headroom_gauge is not None:
            for layer, row in rows.items():
                for tensor in TENSOR_KEYS:
                    rec = row.get(tensor)
                    if isinstance(rec, dict) and "msb" in rec:
                        self._headroom_gauge.labels(
                            layer=layer, tensor=tensor,
                        ).set(INT32_BITS - int(rec["msb"]))
        dp = rows.get("_dp")
        if (self._dp_fits_gauge is not None and dp
                and "grad_fits_int16" in dp):
            self._dp_fits_gauge.set(int(dp["grad_fits_int16"]))

    # ---- reading ----------------------------------------------------------

    def active_alerts(self) -> list[Alert]:
        """Currently-active alerts, most severe first (stable otherwise)."""
        active = [a for rule in self.rules for a in rule.active.values()]
        return sorted(active,
                      key=lambda a: (-_severity_rank(a.severity), a.rule,
                                     a.layer, a.signal))

    def summary(self) -> dict:
        """JSON-ready roll-up: fired counts by severity + active alerts."""
        by_severity = {s: 0 for s in SEVERITIES}
        for a in self.alerts:
            by_severity[a.severity] += 1
        return {
            "steps_observed": self.steps_observed,
            "alerts_fired": len(self.alerts),
            "by_severity": by_severity,
            "active": [a.to_json() for a in self.active_alerts()],
        }


def scan_jsonl(path: str, *, rules: Iterable[Rule] | None = None,
               registry: MetricRegistry | None = None,
               sinks: Iterable[Callable[[Alert], None]] = (),
               ) -> HealthMonitor:
    """Replay a finished run's ``metrics.jsonl`` through a fresh monitor.

    The offline twin of the in-loop wiring: same rules, same windows,
    same alerts — what ``obs_top --once`` and the CI alert smoke use.
    """
    monitor = HealthMonitor(rules, registry=registry, sinks=sinks)
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    monitor.observe_records(records)
    return monitor
