"""Dispatch for the fused IntegerSGD kernel (port of
``repro.kernels.integer_sgd.ops``): ``apply_tree_fused`` applies one
IntegerSGD step across a parameter dict, as ``optimizer.apply_tree`` does.

``backend`` has ``nitro_matmul.ops``' vocabulary: ``cuda`` (the kernel),
``reference`` (``ref.integer_sgd_ref``) and ``auto`` (``cuda`` for CUDA
tensors, ``reference`` for CPU ones).  Nothing falls back to another
backend.
"""

from __future__ import annotations

from repro_torch.core import numerics
from repro_torch.core import optimizer as opt
from repro_torch.kernels.integer_sgd.integer_sgd import integer_sgd_update
from repro_torch.kernels.integer_sgd.ref import integer_sgd_ref


def apply_tree_fused(params: dict, grads: dict, state: opt.IntegerSGDState, *,
                     backend: str = "auto") -> dict:
    """``optimizer.apply_tree`` through the kernel: one launch per weight.

    Every leaf is checked to be integer first, as ``apply_update`` does,
    so a float leaf fails here and not as float arithmetic in a kernel
    whose contract is integer-only.
    """
    # lazy: nitro_matmul's plain versions import this package's ref
    from repro_torch.kernels.nitro_matmul.ops import resolve_backend

    for w in params.values():
        numerics.assert_int(w, "integer_sgd weight")
    for g in grads.values():
        numerics.assert_int(g, "integer_sgd gradient")
    out = {}
    for k, w in params.items():
        fn = (integer_sgd_ref if resolve_backend(backend, w.device) == "reference"
              else integer_sgd_update)
        out[k] = fn(w, grads[k], state.gamma_inv, state.eta_inv)
    return out
