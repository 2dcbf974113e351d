"""Fault-tolerance runtime of the trainer (port of
``repro.train.fault_tolerance``; pure Python): preemption handling and
straggler detection.

  * ``PreemptionGuard``   — SIGTERM/SIGINT → set a flag; the train loop
    checkpoints and exits cleanly at the next step boundary.
  * ``StragglerDetector`` — per-step wall-time EWMA; a step slower than
    ``threshold ×`` the EWMA marks a straggler incident (excluded from
    the EWMA).
  * ``StepTimer``         — host-to-host lap times on the monotonic
    clock.  On CUDA a lap ends when the host has queued the step, not
    when the card has finished it: the timer adds no synchronise.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field


class PreemptionGuard:
    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True

    def simulate(self):
        """Test hook: behave as if SIGTERM arrived."""
        self.requested = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclass
class StragglerDetector:
    """EWMA step-time monitor."""

    alpha: float = 0.1
    threshold: float = 2.5
    warmup_steps: int = 5
    ewma: float = 0.0
    steps: int = 0
    incidents: int = 0
    history: list = field(default_factory=list)

    def record(self, step_time: float) -> bool:
        """Record one step's wall time; True if it was a straggler step."""
        self.steps += 1
        if self.steps <= self.warmup_steps:
            self.ewma = (
                step_time if self.ewma == 0.0
                else (1 - self.alpha) * self.ewma + self.alpha * step_time
            )
            return False
        is_straggler = step_time > self.threshold * self.ewma
        if is_straggler:
            self.incidents += 1
            self.history.append((self.steps, step_time, self.ewma))
        else:
            # stragglers are excluded from the EWMA (they'd poison it)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return is_straggler

    def should_rebalance(self, k: int = 3) -> bool:
        return self.incidents >= k


class StepTimer:
    def __init__(self):
        self.t0 = time.monotonic()

    def lap(self) -> float:
        now = time.monotonic()
        dt = now - self.t0
        self.t0 = now
        return dt
