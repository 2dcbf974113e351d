"""Batched vision serving engine over an ExecutionPlan (port of
``repro.serving.vision``, the static scheduler).

  * ``submit`` enqueues one image on a bounded queue (the caller blocks
    when the engine is saturated) and returns a ``Future``;
  * a daemon worker waits at most ``max_wait_ms`` after the first request
    of a batch, takes up to ``batch_size`` requests, zero-pads to exactly
    ``batch_size``, moves the batch to the plan's device once and runs
    the plan.  Batch N+1 is assembled after batch N's logits are on the
    host.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from repro_torch.infer.plan import ExecutionPlan
from repro_torch.serving.stats import EngineStats


@dataclass
class VisionResult:
    """One classified image: predicted label + integer logits row."""

    label: int
    logits: np.ndarray
    latency_s: float


@dataclass
class Request:
    """One queued classification request (engine-internal)."""

    image: np.ndarray
    future: "Future[VisionResult]"
    t_submit: float


def assemble_batch(items: list[Request], pad: np.ndarray,
                   batch_size: int) -> np.ndarray:
    """Stack ≤ batch_size requests and zero-pad to exactly batch_size."""
    return np.stack([r.image for r in items]
                    + [pad] * (batch_size - len(items)))


def resolve_batch(items: list[Request], logits: np.ndarray,
                  t_done: float) -> None:
    """Deliver one batch's logits to every waiter, skipping futures the
    client cancelled (an unguarded ``set_result`` would raise and kill
    the worker thread)."""
    labels = np.argmax(logits[:len(items)], axis=-1)
    for i, req in enumerate(items):
        if req.future.set_running_or_notify_cancel():
            req.future.set_result(VisionResult(
                label=int(labels[i]),
                logits=logits[i],
                latency_s=t_done - req.t_submit,
            ))


def fail_batch(items: list[Request], exc: BaseException) -> None:
    """Surface a plan failure on every waiter (skipping cancelled ones)."""
    for req in items:
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)


class VisionEngine:
    """Dynamic-batching classifier over a compiled ExecutionPlan.

    ``metrics=`` (a shared ``obs.MetricRegistry``) registers the engine's
    counters as ``serve_*_total{model=<plan name>}`` children of the
    shared families instead of a private registry — the single-model
    equivalent of what ``ModelRegistry(metrics=...)`` does per entry.
    """

    _POISON = object()

    def __init__(
        self,
        plan: ExecutionPlan,
        *,
        batch_size: int = 32,
        max_wait_ms: float = 5.0,
        queue_depth: int = 256,
        metrics=None,
    ):
        self.plan = plan
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1e3
        if metrics is not None:
            self.stats = EngineStats(registry=metrics,
                                     labels={"model": plan.name})
        else:
            self.stats = EngineStats()
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._closed = False
        self._lifecycle = threading.Lock()  # orders submit() vs close()
        self._pad = np.zeros(plan.input_shape, np.int32)
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    # ---- client API -------------------------------------------------------

    def submit(self, image: np.ndarray) -> "Future[VisionResult]":
        """Enqueue one image; blocks only when the engine is saturated."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if tuple(image.shape) != tuple(self.plan.input_shape):
            raise ValueError(
                f"image shape {tuple(image.shape)} != "
                f"plan input shape {tuple(self.plan.input_shape)}"
            )
        fut: Future = Future()
        # the lock orders this put against close()'s poison pill, so no
        # request lands behind the sentinel with a future never resolved
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._q.put(Request(np.asarray(image, np.int32), fut,
                                time.perf_counter()))
        return fut

    def classify(self, images) -> list[int]:
        """Blocking convenience: a list of images → predicted labels."""
        futs = [self.submit(img) for img in images]
        return [f.result().label for f in futs]

    def close(self):
        """Drain in-flight work and stop the worker."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._q.put(self._POISON)
        self._worker.join()

    # ---- worker -----------------------------------------------------------

    def _take_batch(self):
        """Block for the first request, then fill until batch_size or the
        max_wait deadline.  Returns (items, saw_poison)."""
        first = self._q.get()
        if first is self._POISON:
            return [], True
        items = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(items) < self.batch_size:
            remaining = deadline - time.perf_counter()
            try:
                nxt = self._q.get(block=remaining > 0,
                                  timeout=max(remaining, 1e-4))
            except queue.Empty:
                break
            if nxt is self._POISON:
                return items, True
            items.append(nxt)
        return items, False

    def _serve_loop(self):
        while True:
            items, poisoned = self._take_batch()
            if items:
                self._run_batch(items)
            if poisoned:
                return

    def _run_batch(self, items):
        t0 = time.perf_counter()
        n = len(items)
        batch = assemble_batch(items, self._pad, self.batch_size)
        try:
            logits = self.plan.logits(batch).cpu().numpy()
        except Exception as e:  # surface plan failures on every waiter
            fail_batch(items, e)
            return
        t1 = time.perf_counter()
        # stats before futures: a client unblocking on its result and
        # immediately snapshotting must already see this batch counted
        self.stats.record_batch(n, self.batch_size - n, t1 - t0)
        resolve_batch(items, logits, t1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
