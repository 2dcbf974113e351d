"""Faults planted under the timed path, for the tests that show a broken
program comes out not ``correct``, or gives no result.  Each patches the
program in this process; the benchmark's own runs plant none.  The CPU
tests plant them around a driver's run, and the data-parallel driver
plants its ranks' (``drivers.dp_train.run``'s ``fault``), which are
processes of their own.

  * ``state_unchanged`` — the training step (and the data-parallel step's
    update) returns the state it was given;
  * ``half_batch``      — the step or the plan sees only the first half of
    each batch (the plan's other rows repeat the first half's answers);
  * ``answer_altered``  — the plan's first logit of every batch is off by one;
  * ``no_exchange``     — the data-parallel step skips the all-reduce of the
    gradients and metrics;
  * ``jax_package_loaded`` — the JAX package's top-level module appears in
    ``sys.modules``, as if the program had imported it.
"""

from __future__ import annotations

import contextlib
import sys
import types

NAMES = ("state_unchanged", "half_batch", "answer_altered", "no_exchange",
         "jax_package_loaded")


@contextlib.contextmanager
def planted(name: str | None):
    if name is None:
        yield
        return
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
    if name == "jax_package_loaded":
        planted_module = "repro" not in sys.modules
        sys.modules.setdefault("repro", types.ModuleType("repro"))
        try:
            yield
        finally:
            if planted_module:
                del sys.modules["repro"]
        return
    from repro_torch.core import les
    from repro_torch.infer.plan import ExecutionPlan
    from repro_torch.parallel import dp

    saved = [(les, "train_step", les.train_step),
             (ExecutionPlan, "logits", ExecutionPlan.logits),
             (dp, "reduce_gradients", dp.reduce_gradients),
             (dp, "_reduce_metrics", dp._reduce_metrics),
             (les, "compute_gradients", les.compute_gradients),
             (les, "apply_gradients", les.apply_gradients)]
    step, logits, compute = les.train_step, ExecutionPlan.logits, les.compute_gradients
    if name == "state_unchanged":
        les.train_step = lambda state, *a, **k: (state, step(state, *a, **k)[1])
        les.apply_gradients = lambda state, grads, **k: state
    elif name == "half_batch":
        def half_step(state, cfg, x, y, *a, **k):
            return step(state, cfg, x[:len(x) // 2], y[:len(y) // 2], *a, **k)

        def half_compute(state, cfg, x, y, *a, **k):
            return compute(state, cfg, x[:len(x) // 2], y[:len(y) // 2], *a, **k)

        def half_logits(self, x):
            out = logits(self, x[:len(x) // 2])
            return out.repeat(2, 1)[:len(x)]

        les.train_step, les.compute_gradients = half_step, half_compute
        ExecutionPlan.logits = half_logits
    elif name == "answer_altered":
        def altered(self, x):
            out = logits(self, x).clone()
            out[0, 0] += 1
            return out

        ExecutionPlan.logits = altered
    else:
        dp.reduce_gradients = lambda grads, axis, method="psum": grads
        dp._reduce_metrics = lambda metrics, axis: metrics
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
