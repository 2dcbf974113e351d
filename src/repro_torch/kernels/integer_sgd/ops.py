"""Dispatch for the fused IntegerSGD kernel (port of
``repro.kernels.integer_sgd.ops``): ``apply_tree_fused`` applies one
IntegerSGD step across a parameter dict, as ``optimizer.apply_tree`` does,
and ``apply_groups_fused`` across several ``(params, grads, state)``
groups at once.

``backend`` has ``nitro_matmul.ops``' vocabulary: ``cuda`` (the kernel),
``reference`` (``ref.integer_sgd_ref``) and ``auto`` (``cuda`` for CUDA
tensors, ``reference`` for CPU ones).  Nothing falls back to another
backend.
"""

from __future__ import annotations

from repro_torch.core import numerics
from repro_torch.core import optimizer as opt
from repro_torch.kernels.integer_sgd.integer_sgd import integer_sgd_update_many
from repro_torch.kernels.integer_sgd.ref import integer_sgd_ref
from repro_torch.obs import trace


@trace.spanned("dispatch.apply_groups_fused")
def apply_groups_fused(groups, *, backend: str = "auto") -> list[dict]:
    """``optimizer.apply_tree`` over each ``(params, grads, state)`` group:
    the updated params dicts, in order.

    Every leaf is checked to be integer first, as ``apply_update`` does,
    so a float leaf fails here and not as float arithmetic in a kernel
    whose contract is integer-only.  All leaves lie on one device; the
    backend is resolved once for it.  On the kernel every leaf of every
    group goes to one ``integer_sgd_update_many`` call (one launch for up
    to 64 tensors under up to 4 states); on the plain version leaf by leaf.
    """
    # lazy: nitro_matmul's plain versions import this package's ref
    from repro_torch.kernels.nitro_matmul.ops import BACKENDS, resolve_backend

    groups = list(groups)
    leaves = []  # (group, name, w, g, state)
    for i, (params, grads, state) in enumerate(groups):
        for w in params.values():
            numerics.assert_int(w, "integer_sgd weight")
        for g in grads.values():
            numerics.assert_int(g, "integer_sgd gradient")
        leaves += [(i, k, w, grads[k], state) for k, w in params.items()]
    devices = {t.device for _, _, w, g, _ in leaves for t in (w, g)}
    if len(devices) > 1:
        raise ValueError(f"apply_groups_fused: leaves on several devices "
                         f"{sorted(map(str, devices))}")
    if not leaves:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        return [{} for _ in groups]
    out = [{} for _ in groups]
    if resolve_backend(backend, devices.pop()) == "reference":
        for i, k, w, g, state in leaves:
            out[i][k] = integer_sgd_ref(w, g, state.gamma_inv, state.eta_inv)
        return out
    new = integer_sgd_update_many([w for _, _, w, _, _ in leaves],
                                  [g for _, _, _, g, _ in leaves],
                                  [(s.gamma_inv, s.eta_inv) for *_, s in leaves])
    for (i, k, *_), w in zip(leaves, new):
        out[i][k] = w
    return out


def apply_tree_fused(params: dict, grads: dict, state: opt.IntegerSGDState, *,
                     backend: str = "auto") -> dict:
    """``optimizer.apply_tree`` through the kernel: ``apply_groups_fused``
    on one group, one launch for the dict's leaves."""
    return apply_groups_fused([(params, grads, state)], backend=backend)[0]
