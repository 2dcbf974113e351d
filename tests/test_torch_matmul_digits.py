"""PyTorch port: the forward matmul kernels' exact digit arithmetic ≡ the JAX
package, bitwise, on the CPU.

``nitro_matmul`` and ``nitro_matmul_fwd`` run on the card as a split-K GEMM
on the int8 tensor cores over signed base-256 digits of x and w
(``src/repro_torch/kernels/nitro_matmul/csrc/nitro_matmul.cu``).  Their
plain model in ``repro_torch.kernels.nitro_matmul.ref`` (``matmul_x_planes``,
``matmul_w_planes``, ``plan_splits``, ``digit_matmul``,
``nitro_matmul_digits`` and ``nitro_matmul_fwd_digits``) is held here against
the JAX package's ``nitro_matmul`` / ``nitro_matmul_fwd``, the Pallas
kernels in interpret mode and their references: int8 and int32 operands,
x and w of one to four digits each with INT32_MIN/MAX planted, sf a power
of two and not, the ReLU on and off, int8 and int32 outputs, N = 10,
M ∈ {1, 3, 32, 33, 64}, K not a multiple of 32 and K across several
splits (splits planned for 1 to 10,000 resident blocks), every shape the
served and training paths launch, and α_inv from 1 to 2²⁰.  Then the MLP
trajectories that run the training forward: mlp1 and mlp3 split, mlp2
under ``fuse_opt``, 2 steps each, port ≡ JAX, every linear's z* rebuilt by
the digit model.  Tolerance zero, dtype included.  The CUDA kernels
themselves run only on a card: ``tests/test_torch_gpu.py``.

    PYTHONPATH=src python -m pytest -q -n 4 tests/test_torch_matmul_digits.py
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import paper as jpaper
from repro.core import les as jles
from repro.kernels.nitro_matmul import ref as jref
from repro.kernels.nitro_matmul.nitro_matmul import nitro_matmul as j_nitro_matmul
from repro.kernels.nitro_matmul.nitro_matmul import nitro_matmul_fwd as j_nitro_matmul_fwd
from repro_torch.configs import paper as tpaper
from repro_torch.core import les as tles
from repro_torch.core import model as TM
from repro_torch.core import prng
from repro_torch.core.scaling import linear_scale_factor
from repro_torch.kernels.nitro_matmul import ref as tref

I32 = (-(2 ** 31), 2 ** 31 - 1)
_T = {"int8": torch.int8, "int32": torch.int32}
_J = {"int8": jnp.int8, "int32": jnp.int32}
#: bounds of values that need one to four balanced base-256 digits
LIMS = {1: 100, 2: 20000, 3: 2 ** 20, 4: 2 ** 31}


def _eq(t: torch.Tensor, *js) -> None:
    got = t.numpy()
    for j in js:
        j = np.asarray(j)
        assert got.dtype == j.dtype, (got.dtype, j.dtype)
        assert got.shape == j.shape, (got.shape, j.shape)
        np.testing.assert_array_equal(got, j)


def _ints(rng, shape, digits: int) -> np.ndarray:
    """int32 values that need ``digits`` digits (the extremes planted at 4)."""
    lim = LIMS[digits]
    v = rng.integers(-lim, lim, shape, dtype=np.int64).astype(np.int32)
    if digits == 4 and v.size >= 2:
        v.flat[:2] = I32
    return v


def _pair(shape, xd, wd, seed, int8=False):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    if int8:
        return (rng.integers(-128, 128, (m, k)).astype(np.int8),
                rng.integers(-128, 128, (k, n)).astype(np.int8))
    return _ints(rng, (m, k), xd), _ints(rng, (k, n), wd)


# ---------------------------------------------------------------------------
# The planes, the digit counts and the splits
# ---------------------------------------------------------------------------


def test_w_planes_are_transposed_and_padded():
    """w (K, N) → four (N, Kp) planes, K zero-padded to 64; an int8 w is
    its own one plane; the count is the data's."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(_ints(rng, (70, 9), 2))
    planes, nw = tref.matmul_w_planes(w)
    assert nw == 2 and planes.shape == (4, 9, 128) and not planes[:, :, 70:].any()
    rebuilt = sum(planes[i, :, :70].to(torch.int64) << (8 * i) for i in range(4))
    assert torch.equal(rebuilt.to(torch.int32).T, w)
    w8 = w.clamp(-128, 127).to(torch.int8)
    planes, nw = tref.matmul_w_planes(w8)
    assert nw == 1 and planes.shape == (1, 9, 128) and torch.equal(planes[0, :, :70], w8.T)


def test_x_planes_keep_rows_contiguous():
    """x (M, K) → (planes, M, Kp); an int8 x is its own one plane."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_ints(rng, (3, 33), 3))
    planes, nx = tref.matmul_x_planes(x)
    assert nx == 3 and planes.shape == (4, 3, 64) and not planes[3].any()
    rebuilt = sum(planes[i, :, :33].to(torch.int64) << (8 * i) for i in range(4))
    assert torch.equal(rebuilt.to(torch.int32), x)
    x8 = x.clamp(-128, 127).to(torch.int8)
    planes, nx = tref.matmul_x_planes(x8)
    assert nx == 1 and planes.shape == (1, 3, 64) and torch.equal(planes[0, :, :33], x8)


#: the served linear and output layer (batch 32), VGG8B's training linear
#: and mlp4's two layer shapes (batch 64): (M, K, N) → (splits, columns)
#: for an H100's 132 SMs
MAIN_SHAPES = {(32, 2048, 1024): (4, 512), (32, 1024, 10): (4, 256),
               (64, 2048, 1024): (4, 512), (64, 3072, 3000): (2, 1536),
               (64, 3000, 3000): (2, 1536)}


@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_main_path_split_plans(shape):
    """Each main-path call's split plan: several splits of whole 64-deep
    stages, none deeper than 16,384, covering the contraction once."""
    m, k, n = shape
    tiles = -(-n // tref.MATMUL_TILE) * -(-m // tref.MATMUL_TILE)
    kp = -(-k // tref.STAGE) * tref.STAGE
    splits, chunk = tref.plan_splits(tiles, kp)
    assert (splits, chunk) == MAIN_SHAPES[shape]
    assert chunk % tref.STAGE == 0 and chunk <= tref.MAX_SPLIT
    assert (splits - 1) * chunk < kp <= splits * chunk


@pytest.mark.parametrize("kp", [0, 64, 640, 16384, 16448, 40000 // 64 * 64, 65536])
@pytest.mark.parametrize("slots", [1, 132, 264, 10000])
def test_splits_cover_the_contraction(kp, slots):
    """Any depth and card: splits of whole stages, none deeper than 16,384,
    none empty, that cover Kp exactly once."""
    splits, chunk = tref.plan_splits(3, kp, slots)
    assert chunk % tref.STAGE == 0 and 0 < chunk <= tref.MAX_SPLIT
    if kp:
        assert (splits - 1) * chunk < kp <= splits * chunk
    else:
        assert splits == 1


# ---------------------------------------------------------------------------
# The digit-product matmul ≡ JAX's nitro_matmul / nitro_matmul_fwd
# ---------------------------------------------------------------------------

#: (M, K, N): M ∈ {1, 3, 32, 33, 64}, K not a multiple of 32, N = 10 and
#: ragged N across more than one 64-column tile
_SHAPES = {"M1": (1, 7, 10), "M3": (3, 100, 10), "M32": (32, 300, 70), "M33": (33, 130, 10),
           "M64": (64, 200, 67)}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("xd", [1, 2, 3, 4])
@pytest.mark.parametrize("wd", [1, 2, 3, 4])
def test_digits_match_jax(shape, xd, wd):
    """Every (x digits, w digits) variant: (a, z*) ≡ the Pallas kernel
    (interpret) ≡ the JAX reference, and the serving form with the ReLU
    (int8 out, sf not a power of two) or without (int32 out, sf = 2^10)."""
    x, w = _pair(_SHAPES[shape], xd, wd, seed=10 * xd + wd + sum(_SHAPES[shape]))
    tx, tw, jx, jw = torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)
    _, nx = tref.matmul_x_planes(tx)
    assert nx == xd and tref.matmul_w_planes(tw)[1] == wd
    sf = 3 << 9
    a, z = tref.nitro_matmul_fwd_digits(tx, tw, sf=sf, alpha_inv=10)
    ja, jz = j_nitro_matmul_fwd(jx, jw, sf=sf, alpha_inv=10, interpret=True)
    ra, rz = jref.nitro_matmul_fwd_ref(jx, jw, sf=sf, alpha_inv=10)
    _eq(a, ja, ra)
    _eq(z, jz, rz)
    relu = (xd + wd) % 2 == 0
    out = "int8" if relu else "int32"
    kw = dict(sf=sf if relu else 1 << 10, alpha_inv=10, apply_relu=relu)
    got = tref.nitro_matmul_digits(tx, tw, out_dtype=_T[out], **kw)
    _eq(got, j_nitro_matmul(jx, jw, out_dtype=_J[out], interpret=True, **kw),
        jref.nitro_matmul_ref(jx, jw, out_dtype=_J[out], **kw))
    assert torch.equal(got, tref.nitro_matmul_ref(tx, tw, out_dtype=_T[out], **kw))


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("relu,out", [(True, "int8"), (True, "int32"), (False, "int32"),
                                      (False, "int8")])
@pytest.mark.parametrize("sf", [1, 1 << 12, 27 << 8])
def test_int8_operands_match_jax(shape, relu, out, sf):
    """The served path's int8 operands (one product): ≡ JAX's int8-operand
    kernel (interpret) and reference, ReLU on and off, int8 and int32 out,
    sf 1, a power of two and not."""
    x, w = _pair(_SHAPES[shape], 1, 1, seed=sf % 97 + len(out), int8=True)
    tx, tw, jx, jw = torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)
    kw = dict(sf=sf, alpha_inv=10, apply_relu=relu)
    got = tref.nitro_matmul_digits(tx, tw, out_dtype=_T[out], **kw)
    _eq(got,
        j_nitro_matmul(jx, jw, out_dtype=_J[out], operand_dtype="int8", interpret=True, **kw),
        jref.nitro_matmul_ref(jx, jw, out_dtype=_J[out], operand_dtype="int8", **kw))


@pytest.mark.parametrize("alpha_inv", [1, 2, 10, 1000, 2 ** 20])
@pytest.mark.parametrize("sf", [1 << 11, 3 << 11])
def test_alpha_inv_matches_jax(alpha_inv, sf):
    """The NITRO-ReLU leak at α_inv 1 and up to 2²⁰: (a, z*) and the
    served form ≡ JAX's references."""
    x, w = _pair((33, 300, 70), 2, 2, seed=alpha_inv % 1009)
    tx, tw, jx, jw = torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)
    a, z = tref.nitro_matmul_fwd_digits(tx, tw, sf=sf, alpha_inv=alpha_inv)
    ra, rz = jref.nitro_matmul_fwd_ref(jx, jw, sf=sf, alpha_inv=alpha_inv)
    _eq(a, ra)
    _eq(z, rz)
    _eq(tref.nitro_matmul_digits(tx, tw, sf=sf, alpha_inv=alpha_inv, out_dtype=torch.int8),
        jref.nitro_matmul_ref(jx, jw, sf=sf, alpha_inv=alpha_inv, out_dtype=jnp.int8))


@pytest.mark.parametrize("slots", [1, 64, 264, 10000])
@pytest.mark.parametrize("digits", [1, 4])
def test_split_k_matches_jax(slots, digits):
    """K = 40,000 across several splits (at least three: 16,384 columns at
    most each), their s32 sums checked within 2^31 and their tiles added
    mod 2^32 — ≡ the JAX reference on full-range x and w too."""
    x, w = _pair((3, 40000, 10), digits, digits, seed=slots + digits)
    splits, _ = tref.plan_splits(1, -(-40000 // 64) * 64, slots)
    assert splits >= 3
    tx, tw, jx, jw = torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)
    a, z = tref.nitro_matmul_fwd_digits(tx, tw, sf=3 << 9, slots=slots)
    ra, rz = jref.nitro_matmul_fwd_ref(jx, jw, sf=3 << 9)
    _eq(a, ra)
    _eq(z, rz)


@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_main_path_shapes_match_jax(shape):
    """Every shape the main paths launch, at their data's digits: int8 x
    and w on the served shapes (one product), x of the NITRO-ReLU range
    and w of the paper's init range (±4) on the training shapes, and w of
    four digits beside it."""
    m, k, n = shape
    sf = linear_scale_factor(k)
    if m == 32:
        x, w = _pair(shape, 1, 1, seed=k, int8=True)
        tx, tw, jx, jw = (torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x),
                          jnp.asarray(w))
        _eq(tref.nitro_matmul_digits(tx, tw, sf=sf, out_dtype=torch.int8),
            jref.nitro_matmul_ref(jx, jw, sf=sf, out_dtype=jnp.int8, operand_dtype="int8"))
        return
    rng = np.random.default_rng(k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int32)
    for w in (rng.integers(-4, 5, (k, n)).astype(np.int32), _ints(rng, (k, n), 4)):
        tx, tw, jx, jw = torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)
        a, z = tref.nitro_matmul_fwd_digits(tx, tw, sf=sf)
        ra, rz = jref.nitro_matmul_fwd_ref(jx, jw, sf=sf)
        _eq(a, ra)
        _eq(z, rz)


@settings(max_examples=40, deadline=None)
@given(
    m=st.integers(1, 70), k=st.integers(0, 200), n=st.integers(1, 80),
    xd=st.integers(1, 4), wd=st.integers(1, 4), relu=st.booleans(),
    out=st.sampled_from(sorted(_T)), sf=st.sampled_from([1, 2, 3 << 9, 27 << 8]),
    alpha_inv=st.sampled_from([1, 2, 10]), slots=st.sampled_from([1, 4, 264]),
    seed=st.integers(0, 2 ** 16),
)
@example(m=1, k=0, n=1, xd=1, wd=1, relu=True, out="int8", sf=1, alpha_inv=1, slots=1, seed=0)
def test_digits_match_jax_ref(m, k, n, xd, wd, relu, out, sf, alpha_inv, slots, seed):
    """Random small shapes (K = 0 included) and split plans: both digit
    models ≡ the JAX references."""
    x, w = _pair((m, k, n), xd, wd, seed)
    tx, tw, jx, jw = torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)
    kw = dict(sf=sf, alpha_inv=alpha_inv, apply_relu=relu)
    _eq(tref.nitro_matmul_digits(tx, tw, out_dtype=_T[out], slots=slots, **kw),
        jref.nitro_matmul_ref(jx, jw, out_dtype=_J[out], **kw))
    a, z = tref.nitro_matmul_fwd_digits(tx, tw, sf=sf, alpha_inv=alpha_inv, slots=slots)
    ra, rz = jref.nitro_matmul_fwd_ref(jx, jw, sf=sf, alpha_inv=alpha_inv)
    _eq(a, ra)
    _eq(z, rz)


# ---------------------------------------------------------------------------
# The MLP trajectories: every step runs the training forward on each linear
# ---------------------------------------------------------------------------

SCALE = 0.0625
BATCH = 4


def _leaves(params) -> list:
    return ([b[k]["w"] for b in params["blocks"] for k in ("fw", "lr")]
            + [params["output"]["w"]])


def _assert_state_eq(ts, js) -> None:
    for a, b in zip(_leaves(ts.params), _leaves(js.params), strict=True):
        _eq(a, b)
    for grp in ("opt_lr", "opt_fw"):
        for f in ("gamma_inv", "eta_inv"):
            _eq(getattr(getattr(ts, grp), f), getattr(getattr(js, grp), f))
    _eq(ts.step, js.step)


@pytest.mark.parametrize("arch,fuse_opt", [("mlp1", False), ("mlp3", False), ("mlp2", True)])
def test_mlp_trajectory_matches_jax(arch, fuse_opt):
    """Two steps from the same keys ≡ the JAX reference trajectory (params,
    optimiser states, step, loss, correct, local losses); before each step
    the digit model rebuilds every linear's z* from the forward's cached
    input, ≡ the cached z*."""
    tcfg, jcfg = tpaper.get(arch, scale=SCALE), jpaper.get(arch, scale=SCALE)
    ts = tles.create_train_state(prng.PRNGKey(3), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(3), jcfg)
    jstep = jax.jit(functools.partial(jles.train_step, cfg=jcfg, fuse_opt=fuse_opt,
                                      backend="reference"))
    for it in range(2):
        rng = np.random.default_rng(50 + it)
        x = rng.integers(-127, 128, (BATCH, *tcfg.input_shape)).astype(np.int32)
        y = rng.integers(0, tcfg.num_classes, BATCH).astype(np.int32)
        _, _, caches, _ = TM.forward(ts.params, tcfg, torch.from_numpy(x), train=True,
                                     key=prng.PRNGKey(it))
        linears = 0
        for spec, p, cache in zip(tcfg.blocks, ts.params["blocks"], caches):
            assert spec.kind == "linear"
            xin = cache["linear"]
            _, dz = tref.nitro_matmul_fwd_digits(
                xin, p["fw"]["w"], sf=linear_scale_factor(xin.shape[-1]),
                alpha_inv=spec.alpha_inv)
            assert torch.equal(dz, cache["z_star"])
            linears += 1
        assert linears == len(tcfg.blocks) >= 2
        ts, tm = tles.train_step(ts, tcfg, torch.from_numpy(x), torch.from_numpy(y),
                                 prng.PRNGKey(it), fuse_opt=fuse_opt)
        js, jm = jstep(js, x=jnp.asarray(x), labels=jnp.asarray(y),
                       key=jax.random.PRNGKey(it))
        _eq(tm.loss, jm.loss)
        _eq(tm.correct, jm.correct)
        _eq(tm.local_losses, jm.local_losses)
        _assert_state_eq(ts, js)
