"""Python wrapper of the hand-written IntegerSGD CUDA kernel.

``integer_sgd_update_many`` replaces the Pallas ``integer_sgd_update``
(``_integer_sgd_kernel``), which updates one tensor a call, for a whole
list of tensors: one IntegerSGD step, ``W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋)``,
elementwise on each, each under its own optimiser state, in one launch per
table of up to ``TABLE_TENSORS`` tensors and ``TABLE_STATES`` states.
``integer_sgd_update`` keeps the JAX signature and is its one-tensor call.

Source: ``csrc/integer_sgd.cu``, which notes the kernel's bound and
design.  ``plan_tables`` packs the tables and is plain Python, so the CPU
tests hold it.  The wrappers take CUDA tensors only;
``ops.apply_groups_fused`` sends CPU tensors to the plain version in
``ref.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.obs import trace

#: tensors and optimiser states a launch takes (TABLE_TENSORS /
#: TABLE_STATES in csrc/integer_sgd.cu)
TABLE_TENSORS = 64
TABLE_STATES = 4
#: weights a block owns (CHUNK in csrc/integer_sgd.cu)
CHUNK = 4096


class _Tensor(ctypes.Structure):
    """``SgdTensor`` of csrc/integer_sgd.cu."""

    _fields_ = [("w", ctypes.c_void_p), ("g", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("block0", ctypes.c_int), ("state", ctypes.c_int)]


class _Table(ctypes.Structure):
    """``SgdTable`` of csrc/integer_sgd.cu (its size pinned by a
    ``static_assert`` there and checked against the library at load)."""

    _fields_ = [("t", _Tensor * TABLE_TENSORS),
                ("gamma_inv", ctypes.c_void_p * TABLE_STATES),
                ("eta_inv", ctypes.c_void_p * TABLE_STATES),
                ("count", ctypes.c_int), ("blocks", ctypes.c_int)]


class TablePlan(NamedTuple):
    """One launch: ``entries`` are (tensor index, state slot, first block)
    in block order, ``states`` the state keys by slot, ``blocks`` the grid."""

    entries: tuple
    states: tuple
    blocks: int


def plan_tables(sizes, state_keys) -> list[TablePlan]:
    """Pack tensors of ``sizes`` weights, tensor i under the optimiser state
    ``state_keys[i]`` (any hashable), into launch tables, in order.

    A table closes when it holds ``TABLE_TENSORS`` tensors or a state
    beyond ``TABLE_STATES`` would join it.  A tensor owns ⌈n / CHUNK⌉ consecutive
    blocks from its entry's first block; an empty tensor gets no entry.
    """
    sizes, state_keys = list(sizes), list(state_keys)
    if len(sizes) != len(state_keys):
        raise ValueError(f"{len(sizes)} sizes but {len(state_keys)} states")
    tables: list[TablePlan] = []
    entries, states, blocks = [], [], 0
    for i, (n, key) in enumerate(zip(sizes, state_keys)):
        if n == 0:
            continue
        if n >= 2 ** 31:
            raise ValueError("integer_sgd_update: tensor must have fewer than 2^31 elements")
        if len(entries) == TABLE_TENSORS or (key not in states
                                             and len(states) == TABLE_STATES):
            tables.append(TablePlan(tuple(entries), tuple(states), blocks))
            entries, states, blocks = [], [], 0
        if key not in states:
            states.append(key)
        entries.append((i, states.index(key), blocks))
        blocks += -(-n // CHUNK)
    if entries:
        tables.append(TablePlan(tuple(entries), tuple(states), blocks))
    return tables


@functools.lru_cache(maxsize=None)
def _launcher():
    lib, launch = cuda_lib.entry("integer_sgd", "integer_sgd_many_launch", 1, 0)
    lib.integer_sgd_table_bytes.argtypes, lib.integer_sgd_table_bytes.restype = [], ctypes.c_int
    size = lib.integer_sgd_table_bytes()
    if size != ctypes.sizeof(_Table):
        raise RuntimeError(f"integer_sgd: the library's table is {size} bytes, the "
                           f"wrapper's {ctypes.sizeof(_Table)}")
    return lib, launch


@trace.spanned("kernel.integer_sgd_update")
def integer_sgd_update_many(ws, gs, states) -> list[torch.Tensor]:
    """One IntegerSGD step on every tensor of ``ws`` on the card, one launch
    per table of ``plan_tables``: W′ of each W's shape, int32, each its own
    tensor.

    ``gs[i]`` is ``ws[i]``'s gradient and ``states[i]`` its optimiser
    state's ``(γ_inv, η_inv)`` — an ``IntegerSGDState`` or a pair of 0-d
    int32 tensors on the card (the kernel reads them there: no host sync)
    or of ints; γ_inv must not be 0.
    """
    ws, gs, states = list(ws), list(gs), list(states)
    if not len(ws) == len(gs) == len(states):
        raise ValueError(f"integer_sgd_update: {len(ws)} weights, {len(gs)} gradients "
                         f"and {len(states)} states")
    if not ws:
        return []
    for w, g in zip(ws, gs):
        if w.shape != g.shape:
            raise ValueError(f"integer_sgd_update: w {tuple(w.shape)} and g "
                             f"{tuple(g.shape)} differ in shape")
    cuda_lib.require_cuda("integer_sgd_update", *ws, *gs)
    device = ws[0].device
    lifted = cuda_lib.as_int32("integer_sgd_update", *ws, *gs)
    ws, gs = lifted[:len(ws)], lifted[len(ws):]
    scalars, keys = {}, []  # each state's divisors once, keyed by its objects
    for gamma_inv, eta_inv in states:
        key = (id(gamma_inv), id(eta_inv))
        if key not in scalars:
            scalars[key] = (cuda_lib.sgd_scalar("gamma_inv", gamma_inv, device),
                            cuda_lib.sgd_scalar("eta_inv", eta_inv, device))
        keys.append(key)
    outs = [torch.empty_like(w) for w in ws]
    plans = plan_tables([w.numel() for w in ws], keys)
    if not plans:
        return outs
    lib, launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for plan in plans:
            tab = _Table()
            for j, (i, slot, block0) in enumerate(plan.entries):
                tab.t[j] = _Tensor(ws[i].data_ptr(), gs[i].data_ptr(), outs[i].data_ptr(),
                                   ws[i].numel(), block0, slot)
            for slot, key in enumerate(plan.states):
                gamma, eta = scalars[key]
                tab.gamma_inv[slot], tab.eta_inv[slot] = gamma.data_ptr(), eta.data_ptr()
            tab.count, tab.blocks = len(plan.entries), plan.blocks
            cuda_lib.check(lib, launch(ctypes.addressof(tab), stream), "integer_sgd_update")
            integer_sgd_update.launches.add()
    return outs


def integer_sgd_update(w: torch.Tensor, g: torch.Tensor, gamma_inv,
                       eta_inv) -> torch.Tensor:
    """One IntegerSGD step on the card: W′ of W's shape, int32 — the
    one-tensor call of ``integer_sgd_update_many``."""
    return integer_sgd_update_many([w], [g], [(gamma_inv, eta_inv)])[0]


#: launches of the CUDA kernel (both wrappers add one per launch)
integer_sgd_update.launches = cuda_lib.LaunchCounter()
integer_sgd_update_many.launches = integer_sgd_update.launches
