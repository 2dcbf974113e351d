"""PyTorch port, the many-tensor IntegerSGD kernel (#11) on the CPU.

What the CUDA kernel (``kernels/integer_sgd/csrc/integer_sgd.cu``) does
that the CPU can hold without it:

  * the table-packing plan (``integer_sgd.plan_tables``) and the kernel's
    block → tensor → weights mapping, modelled here from the kernel's own
    constants: every weight of every tensor covered exactly once, under
    its own state, in ⌈tensors / cap⌉ launches;
  * the ``ctypes`` table against the ``.cu`` struct layout;
  * ``SgdMagic``'s floor division (``Div31``: a 32-bit multiply-high, an
    add and a shift) as a numpy model, against JAX's ``integer_sgd_ref``
    over γ_inv and η_inv of every sign and size and full-range W and g;
  * the many-group plain apply (``ops.apply_groups_fused``) against JAX's
    ``apply_tree_fused`` on its Pallas kernel in interpret mode, group by
    group, on small-width trees of every paper architecture.

Tolerance zero, dtype included.  The kernel itself runs only on a card:
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import ctypes
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import model as jmodel
from repro.core import optimizer as jopt
from repro.kernels.integer_sgd import integer_sgd_ref as j_integer_sgd_ref
from repro.kernels.integer_sgd.ops import apply_tree_fused as j_apply_tree_fused
from repro_torch.core import optimizer as topt
from repro_torch.kernels.integer_sgd import (
    apply_groups_fused,
    apply_tree_fused,
    integer_sgd_ref,
    integer_sgd_update_many,
)
from repro_torch.kernels.integer_sgd import integer_sgd as isgd

I32 = (-(2 ** 31), 2 ** 31 - 1)
CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
      / "integer_sgd" / "csrc" / "integer_sgd.cu").read_text()


def _cu_const(name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);", CU).group(1)


THREADS = int(_cu_const("THREADS"))
UNROLL = int(_cu_const("UNROLL"))


def _tree_shapes(arch: str, scale: float) -> list[tuple]:
    """The shapes of ``arch``'s weight tensors in the fused apply's order
    (each block's fw, then its lr; the output layer last), from the JAX
    package's init."""
    p = jmodel.init_params(jax.random.PRNGKey(0), jpaper.get(arch, scale=scale))
    leaves = [b[k]["w"] for b in p["blocks"] for k in ("fw", "lr")] + [p["output"]["w"]]
    return [tuple(w.shape) for w in leaves]


#: the fused apply's tensors at full width (``_tree_shapes(arch, 1.0)``,
#: written out: the init is too large to run at collection)
VGG8B_SIZES = [3 * 3 * 3 * 128, 3200 * 10, 3 * 3 * 128 * 256, 4096 * 10, 3 * 3 * 256 * 256,
               4096 * 10, 3 * 3 * 256 * 512, 2048 * 10, 3 * 3 * 512 * 512, 2048 * 10,
               3 * 3 * 512 * 512, 2048 * 10, 2048 * 1024, 1024 * 10, 1024 * 10]
MLP4_SIZES = [3072 * 3000, 3000 * 10, 3000 * 3000, 3000 * 10, 3000 * 3000, 3000 * 10,
              3000 * 10]


# ---------------------------------------------------------------------------
# The packing plan and the kernel's block mapping
# ---------------------------------------------------------------------------


def test_kernel_constants_and_table_layout_match_the_source():
    """The wrapper's constants and ctypes structs are the .cu's."""
    assert int(_cu_const("TABLE_TENSORS")) == isgd.TABLE_TENSORS
    assert int(_cu_const("TABLE_STATES")) == isgd.TABLE_STATES
    assert THREADS * UNROLL * 4 == isgd.CHUNK
    assert re.search(r"sizeof\(SgdTensor\) == (\d+)", CU).group(1) == str(
        ctypes.sizeof(isgd._Tensor))
    assert re.search(r"sizeof\(SgdTable\) == (\d+)", CU).group(1) == str(
        ctypes.sizeof(isgd._Table))
    assert ctypes.sizeof(isgd._Table) <= 4096


@functools.lru_cache(maxsize=None)
def _block_exact(length: int, aligned: bool) -> bool:
    """Whether a block of ``length`` weights updates each of them exactly
    once, indexed as the kernel indexes them: UNROLL 16-byte words a thread
    and the ragged tail one weight a thread when the tensor is aligned,
    CHUNK / THREADS single weights a thread otherwise."""
    t = np.arange(THREADS)
    if aligned:
        q = length // 4
        k = (t[:, None] + THREADS * np.arange(UNROLL)[None, :]).ravel()
        words = k[k < q]
        tail = 4 * q + t
        idx = np.concatenate([(4 * words[:, None] + np.arange(4)).ravel(), tail[tail < length]])
    else:
        k = (t[:, None] + THREADS * np.arange(isgd.CHUNK // THREADS)[None, :]).ravel()
        idx = k[k < length]
    return np.array_equal(np.sort(idx), np.arange(length))


def _check_cover(sizes, keys, plans, aligned) -> None:
    """Run the kernel's block → entry search and chunk arithmetic over every
    table: each tensor's blocks must tile its weights, each block update
    its chunk exactly once, under the tensor's own state."""
    starts = [[] for _ in sizes]
    for plan in plans:
        assert 1 <= len(plan.entries) <= isgd.TABLE_TENSORS
        assert len(plan.states) <= isgd.TABLE_STATES
        firsts = [b0 for _, _, b0 in plan.entries]
        assert firsts == sorted(firsts) and firsts[0] == 0
        for b in range(plan.blocks):
            lo, hi = 0, len(firsts) - 1
            while lo < hi:  # the kernel's binary search
                mid = (lo + hi + 1) // 2
                lo, hi = (mid, hi) if firsts[mid] <= b else (lo, mid - 1)
            i, slot, b0 = plan.entries[lo]
            start = (b - b0) * isgd.CHUNK
            length = min(isgd.CHUNK, sizes[i] - start)
            assert length > 0, "a block with no weights"
            assert _block_exact(length, aligned[i])
            assert plan.states[slot] == keys[i]
            starts[i].append(start)
    for n, st in zip(sizes, starts):
        assert sorted(st) == list(range(0, n, isgd.CHUNK))  # chunks tile [0, n) once


_LONG = list(np.random.default_rng(0).integers(1, 20_000, 150))
PLAN_CASES = {
    "1": [1], "3": [3], "4": [4], "5": [5], "1001": [1001],
    "chunk edges": [isgd.CHUNK - 1, isgd.CHUNK, isgd.CHUNK + 1, 2 * isgd.CHUNK + 3],
    "vgg8b": VGG8B_SIZES, "mlp4": MLP4_SIZES,
    "longer than the cap": _LONG,
    "empty leaves": [0, 7, 0, 0, 4096, 0, 3],
    "cap exactly": [5] * isgd.TABLE_TENSORS,
    "cap plus one": [5] * (isgd.TABLE_TENSORS + 1),
}


def test_true_sizes_of_the_fused_apply():
    """The sizes the kernel's header states: VGG8B 15 tensors, 9,079,424
    weights (108.95 MB moved); mlp4 7 tensors, 27,336,000 (328.0 MB); the
    init at 1/16 width has the same tensor count."""
    assert (len(VGG8B_SIZES), sum(VGG8B_SIZES)) == (15, 9_079_424)
    assert (len(MLP4_SIZES), sum(MLP4_SIZES)) == (7, 27_336_000)
    assert round(12 * sum(VGG8B_SIZES) / 1e6, 2) == 108.95
    assert round(12 * sum(MLP4_SIZES) / 1e6, 1) == 328.0
    assert len(_tree_shapes("vgg8b", 0.0625)) == 15 and len(_tree_shapes("mlp4", 0.0625)) == 7


@pytest.mark.parametrize("states", [1, 2, 3], ids=["one state", "two states", "three states"])
@pytest.mark.parametrize("aligned", ["aligned", "misaligned", "mixed"])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_covers_every_weight_once(case, aligned, states):
    sizes = PLAN_CASES[case]
    keys = [f"s{i % states}" for i in range(len(sizes))]
    flags = {"aligned": [True] * len(sizes), "misaligned": [False] * len(sizes),
             "mixed": [i % 2 == 0 for i in range(len(sizes))]}[aligned]
    plans = isgd.plan_tables(sizes, keys)
    _check_cover(sizes, keys, plans, flags)
    live = sum(1 for n in sizes if n)
    assert len(plans) == -(-live // isgd.TABLE_TENSORS)
    assert sum(len(p.entries) for p in plans) == live
    assert all(p.blocks == sum(-(-sizes[i] // isgd.CHUNK) for i, _, _ in p.entries)
               for p in plans)


def test_plan_closes_a_table_for_a_state_beyond_its_slots():
    """Five states in turn over ten tensors: each table holds at most four
    states, and every tensor keeps its own."""
    keys = list("abcdeabcde")
    plans = isgd.plan_tables([9] * 10, keys)
    assert [len(p.states) for p in plans] == [4, 4, 2]
    for p in plans:
        for i, slot, _ in p.entries:
            assert p.states[slot] == keys[i]


def test_plan_rejects_oversized_tensors_and_mismatched_lists():
    with pytest.raises(ValueError, match="fewer than 2\\^31"):
        isgd.plan_tables([2 ** 31], ["a"])
    with pytest.raises(ValueError, match="sizes but"):
        isgd.plan_tables([1, 2], ["a"])
    assert isgd.plan_tables([], []) == [] and isgd.plan_tables([0, 0], "ab") == []


def test_many_wrapper_refuses_cpu_tensors():
    """CPU tensors never reach the kernel: the wrapper raises before any
    build or launch, and nothing is counted."""
    w = torch.zeros(5, dtype=torch.int32)
    before = integer_sgd_update_many.launches.value
    with pytest.raises(ValueError, match="on one CUDA device"):
        integer_sgd_update_many([w, w], [w, w], [(512, 0), (3, 0)])
    with pytest.raises(ValueError, match="differ in shape"):
        integer_sgd_update_many([w], [w[:4]], [(512, 0)])
    with pytest.raises(ValueError, match="2 weights, 1 gradients"):
        integer_sgd_update_many([w, w], [w], [(512, 0)])
    assert integer_sgd_update_many([], [], []) == []
    assert integer_sgd_update_many.launches.value == before


# ---------------------------------------------------------------------------
# SgdMagic's floor division, modelled in numpy
# ---------------------------------------------------------------------------


def _div31(d: int) -> tuple[int, int]:
    """Div31's (l, m) for a divisor d in [1, 2^31]."""
    assert 1 <= d <= 2 ** 31
    l = 0
    while (1 << l) < d:
        l += 1
    m = ((((1 << l) - d) << 32) // d + 1)
    assert 0 < m < 2 ** 32
    return l, m


def _floor_div31(lm, a: np.ndarray) -> np.ndarray:
    """Div31::floor_div on int64 ``a`` in [−2^31, 2^31]: the sign mask s,
    n = (unsigned)a ^ s, q = (umulhi(m, n) + n) >> l, then q ^ s; the low
    32 bits, as the kernel's (int) cast keeps them."""
    l, m = lm
    s = np.where(a < 0, np.uint64(0xFFFFFFFF), np.uint64(0))
    n = (a.astype(np.uint64) & np.uint64(0xFFFFFFFF)) ^ s
    hi = (np.uint64(m) * n) >> np.uint64(32)  # < 2^64: m, n < 2^32
    total = hi + n
    assert int(total.max(initial=0)) < 2 ** 32  # the 32-bit add cannot overflow
    q = total >> np.uint64(l)
    return ((q ^ s) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _integer_sgd_magic(w: np.ndarray, g: np.ndarray, gamma: int, eta: int) -> np.ndarray:
    """nitro::integer_sgd on SgdMagic, in numpy."""
    gl = _div31(abs(gamma))
    el = _div31(max(eta, 1))
    ga = -g.astype(np.int64) if gamma < 0 else g.astype(np.int64)
    delta = _floor_div31(gl, ga)
    decay = _floor_div31(el, w.astype(np.int64)) if eta != 0 else np.zeros_like(delta)
    return (w.view(np.uint32) - (delta + decay)).view(np.int32)


GAMMAS = [1, 2, 3, 7, 512, 512 * 640 * 9, 2 ** 31 - 1, -1, -3, -(2 ** 31)]
ETAS = [0, 1, 5, 12000, 2 ** 31 - 1]


@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("gamma", GAMMAS)
def test_sgd_magic_model_matches_jax(gamma, eta):
    rng = np.random.default_rng(abs(gamma) % 1009 + eta % 997)
    edges = np.array([I32[0], I32[0] + 1, -(2 ** 30), -eta - 1, -eta, -1, 0, 1,
                      eta - 1, eta, 2 ** 30, I32[1] - 1, I32[1]], np.int64)
    edges = np.clip(edges, *I32).astype(np.int32)
    rand = rng.integers(*I32, 4000, dtype=np.int64, endpoint=True).astype(np.int32)
    small = rng.integers(-70000, 70000, 1000).astype(np.int32)
    w = np.concatenate([edges, rand, small, np.repeat(edges, len(edges))])
    g = np.concatenate([edges[::-1], rng.permutation(rand), small[::-1],
                        np.tile(edges, len(edges))])
    got = _integer_sgd_magic(w, g, gamma, eta)
    want = np.asarray(j_integer_sgd_ref(jnp.asarray(w), jnp.asarray(g), gamma, eta))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, integer_sgd_ref(torch.from_numpy(w), torch.from_numpy(g), gamma, eta).numpy())


def test_div31_quotients_on_every_divisor_edge():
    """n / d by Div31 for n at 0, 1, d − 1, d, d + 1, 2^31 − 1 and 2^31 over
    divisors at the powers of two and their neighbours."""
    ds = sorted({d for k in range(32) for d in (2 ** k - 1, 2 ** k, 2 ** k + 1)
                 if 1 <= d <= 2 ** 31})
    for d in ds:
        n = np.array([v for v in (0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31)
                      if 0 <= v <= 2 ** 31], np.int64)
        got = _floor_div31(_div31(d), n).astype(np.int64)
        np.testing.assert_array_equal(got, (n // d) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# The many-group apply ≡ JAX's apply_tree_fused, group by group
# ---------------------------------------------------------------------------

ARCHS = ["vgg8b", "vgg11b", "mlp1", "mlp2", "mlp3", "mlp4"]


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_groups_fused_matches_jax_interpret(arch, backend):
    """Every group of a small-width tree (each block's fw under the forward
    layers' state, its lr and the output layer under the learning layers')
    through one apply_groups_fused call ≡ JAX's apply_tree_fused on the
    Pallas kernel in interpret mode, group by group; full-range gradients."""
    cfg = jpaper.get(arch, scale=0.0625)
    shapes = _tree_shapes(arch, 0.0625)
    rng = np.random.default_rng(len(arch) + len(shapes))
    af = jopt.amplification_factor(cfg.num_classes)
    fw, lr = (cfg.gamma_inv * af * 3, cfg.eta_fw), (cfg.gamma_inv, cfg.eta_lr)
    tstates = {"fw": topt.init_state(*fw), "lr": topt.init_state(*lr)}
    jstates = {"fw": jopt.init_state(*fw), "lr": jopt.init_state(*lr)}
    groups = [("fw" if i % 2 == 0 and i < len(shapes) - 1 else "lr", shape)
              for i, shape in enumerate(shapes)]
    trees = [(k, {"w": rng.integers(-(2 ** 20), 2 ** 20, shape).astype(np.int32)},
              {"w": rng.integers(*I32, shape, endpoint=True).astype(np.int32)})
             for k, shape in groups]
    got = apply_groups_fused(
        [({"w": torch.from_numpy(p["w"])}, {"w": torch.from_numpy(g["w"])}, tstates[k])
         for k, p, g in trees], backend=backend)
    assert len(got) == len(trees)
    for (k, p, g), new in zip(trees, got):
        want = j_apply_tree_fused({"w": jnp.asarray(p["w"])}, {"w": jnp.asarray(g["w"])},
                                  jstates[k], backend="interpret")
        assert list(new) == ["w"]
        assert new["w"].dtype == torch.int32
        np.testing.assert_array_equal(new["w"].numpy(), np.asarray(want["w"]))


def test_apply_groups_fused_checks_devices_backend_and_leaves():
    state = topt.init_state(512, 3000)
    w = torch.arange(-6, 6, dtype=torch.int32).reshape(3, 4)
    grp = ({"w": w}, {"w": w}, state)
    with pytest.raises(TypeError, match="integer_sgd weight"):
        apply_groups_fused([grp, ({"w": w.float()}, {"w": w}, state)])
    with pytest.raises(TypeError, match="integer_sgd gradient"):
        apply_groups_fused([grp, ({"w": w}, {"w": w.double()}, state)])
    with pytest.raises(ValueError, match="unknown backend"):
        apply_groups_fused([grp], backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        apply_groups_fused([], backend="pallas")
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA tensors"):
        apply_groups_fused([grp, grp], backend="cuda")
    meta = torch.empty((3, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        apply_groups_fused([grp, ({"w": meta}, {"w": meta}, state)])
    with pytest.raises(ValueError, match="several devices"):
        apply_groups_fused([({"w": w}, {"w": meta}, state)])
    assert apply_groups_fused([]) == []
    assert apply_groups_fused([({}, {}, state), ({}, {}, state)]) == [{}, {}]
    # the one-group case is apply_tree_fused
    out = apply_groups_fused([grp, ({"a": w, "b": -w}, {"a": w, "b": w}, state)])
    assert torch.equal(out[0]["w"], apply_tree_fused(*grp)["w"])
    assert list(out[1]) == ["a", "b"]
    assert torch.equal(out[1]["b"], integer_sgd_ref(-w, w, 512, 3000))
