"""PyTorch port: the linear weight-gradient kernels' exact digit arithmetic ≡
the JAX package, bitwise, on the CPU.

``nitro_matmul_grad_w`` and ``nitro_matmul_grad_w_opt`` run on the card as a
shallow GEMM on the int8 tensor cores over signed base-256 digits of x and
of the masked δ (``src/repro_torch/kernels/csrc_common/linear_grad_w.cuh``):
one block per 128 × 64 output tile, the batch in chunks of 64 samples, only
the digit pairs the tile's own digit counts allow, the pairs of one shift
summed in one s32 set and folded into the total after every chunk.  Their
plain model in ``repro_torch.kernels.nitro_matmul.ref`` (``tile_digits``,
``grad_w_digits`` and ``grad_w_opt_digits``) is held here against the JAX
package's ``nitro_matmul_grad_w`` / ``nitro_matmul_grad_w_opt``, the
Pallas kernels in interpret mode and their references: x and masked δ of
one to four digits with INT32_MIN/MAX planted, z* that masks and z* that
does not, α_inv from 1 to 2²⁰, batches of 1, 3, 33, 64 and 16,385 (257
chunks), M and N off the tile (1, 63, 65, 129), every shape the training
paths launch, and γ_inv / η_inv at 1, 0 and large.  Then the training
trajectories that run these kernels and no test held before: vgg8b at
batch 1 (split) and at batch 3 (``fuse_opt``), and mlp4 under
``fuse_opt``, 2 steps each, port ≡ JAX, every linear block's grad_W (or
W′) rebuilt by the digit model.  Tolerance zero, dtype included.  The CUDA
kernels themselves run only on a card: ``tests/test_torch_gpu.py``.

    PYTHONPATH=src python -m pytest -q -n 4 tests/test_torch_grad_w_digits.py
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
from repro.kernels.nitro_matmul import ops as jops
from repro.kernels.nitro_matmul import ref as jref
from repro.kernels.nitro_matmul.nitro_matmul import nitro_matmul_grad_w as j_grad_w
from repro.kernels.nitro_matmul.nitro_matmul import nitro_matmul_grad_w_opt as j_grad_w_opt
from repro_torch.configs import paper as tpaper
from repro_torch.core import blocks as TB
from repro_torch.core import les as tles
from repro_torch.core import model as TM
from repro_torch.core import prng
from repro_torch.core.losses import one_hot_int
from repro_torch.kernels.digit_planes import digits_needed, s8_digits
from repro_torch.kernels.nitro_matmul import ref as tref

I32 = (-(2 ** 31), 2 ** 31 - 1)
#: bounds of values that need one to four balanced base-256 digits
LIMS = {1: 100, 2: 20000, 3: 2 ** 20, 4: 2 ** 31}
#: (γ_inv, η_inv): 1 without decay, 1 with η 1, the forward layers' state
#: of a VGG8B run, large ones, and a negative γ_inv at the int32 edge
SGD_STATES = [(1, 0), (1, 1), (327680, 25000), (2 ** 31 - 1, 2 ** 30), (-(2 ** 31), 7)]


def _eq(t: torch.Tensor, *js) -> None:
    got = t.numpy()
    for j in js:
        j = np.asarray(j)
        assert got.dtype == j.dtype, (got.dtype, j.dtype)
        assert got.shape == j.shape, (got.shape, j.shape)
        np.testing.assert_array_equal(got, j)


def _ints(rng, shape, digits: int) -> np.ndarray:
    """int32 values that need ``digits`` digits: the range's largest value
    planted first (the extremes at 4)."""
    v = rng.integers(-LIMS[digits], LIMS[digits], shape, dtype=np.int64).astype(np.int32)
    if digits == 4 and v.size >= 2:
        v.flat[:2] = I32
    elif v.size:
        v.flat[0] = LIMS[digits] - 1
    return v


def _operands(shape, xd, gd, seed, masks=True):
    """x of ``xd`` digits and a δ whose masked values need ``gd`` digits:
    z* spans every NITRO-ReLU segment (``masks``) or only the identity
    one, and is 0 where δ's first two values (its planted extremes) sit,
    so the mask keeps them."""
    b, m, n = shape
    rng = np.random.default_rng(seed)
    x, delta = _ints(rng, (b, m), xd), _ints(rng, (b, n), gd)
    z = rng.integers(-300, 301 if masks else 128, (b, n)).astype(np.int32)
    if not masks:
        z = np.abs(z) % 128
    z.flat[:2] = 0
    return x, delta, z


def _j_opt_ref(x, delta, z, w, gamma, eta, alpha_inv):
    """JAX's W′ on its reference backend: grad_W, then IntegerSGD."""
    return jops.grad_w_opt_matmul(x, delta, z, w, gamma, eta, alpha_inv=alpha_inv,
                                  backend="reference")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# The digits and the per-tile counts
# ---------------------------------------------------------------------------


def test_digit_word_is_s8_digits():
    """The kernel's digit word (v + 0x808080) ^ 0x808080 holds v's balanced
    digits d0..d3 as bytes, the model's s8_digits, at the edges of every
    digit count and on random int32."""
    rng = np.random.default_rng(0)
    edges = [0, 1, -1, 127, 128, -128, -129, 32639, 32640, -32896, -32897, 8355711,
             8355712, -8421504, -8421505, *I32]
    v = np.concatenate([np.array(edges, np.int64),
                        rng.integers(*I32, 100000, endpoint=True)]).astype(np.int32)
    word = ((v.astype(np.int64) & 0xFFFFFFFF) + 0x808080 & 0xFFFFFFFF) ^ 0x808080
    want = s8_digits(torch.from_numpy(v)).numpy().astype(np.uint8)
    got = np.stack([(word >> (8 * i)) & 255 for i in range(4)]).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_tile_digits_counts_each_tile():
    """Each column gets its tile's count: the digits the tile's values
    need, 1 for a tile of zeros; ragged last tile."""
    x = torch.zeros((3, 300), dtype=torch.int32)
    x[1, 5] = 200          # tile 0: two digits
    x[0, 130] = -(2 ** 31)  # tile 1: four
    x[2, 299] = 100         # tile 2 (44 columns): one
    need = tref.tile_digits(s8_digits(x), 128)
    assert need.tolist() == [2] * 128 + [4] * 128 + [1] * 44
    assert tref.tile_digits(s8_digits(torch.zeros((0, 5), dtype=torch.int32)), 64).tolist() \
        == [1] * 5


# ---------------------------------------------------------------------------
# grad_W ≡ JAX's nitro_matmul_grad_w
# ---------------------------------------------------------------------------

#: (B, M, N): contractions shorter than one MMA step, M and N off the
#: 128 × 64 tile, more than one tile each way
_SHAPES = {"B1": (1, 63, 65), "B3": (3, 129, 1), "B33": (33, 65, 129), "B64": (64, 1, 63)}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("xd", [1, 2, 3, 4])
@pytest.mark.parametrize("gd", [1, 2, 3, 4])
def test_digits_match_jax(shape, xd, gd):
    """Every (x digits, masked δ digits) variant: grad_W ≡ the Pallas
    kernel (interpret) ≡ the JAX reference ≡ the port's plain version."""
    x, delta, z = _operands(_SHAPES[shape], xd, gd, seed=10 * xd + gd + sum(_SHAPES[shape]))
    tx, td, tz = _t(x, delta, z)
    assert digits_needed(tx) == xd
    assert digits_needed(tref.masked_delta(td, tz, 10)) == gd
    got = tref.grad_w_digits(tx, td, tz, alpha_inv=10)
    jx, jd, jz = _j(x, delta, z)
    _eq(got, j_grad_w(jx, jd, jz, alpha_inv=10, interpret=True),
        jref.nitro_matmul_grad_w_ref(jx, jd, jz, alpha_inv=10))
    assert torch.equal(got, tref.nitro_matmul_grad_w_ref(tx, td, tz, alpha_inv=10))


@pytest.mark.parametrize("alpha_inv", [1, 2, 10, 2 ** 20])
@pytest.mark.parametrize("masks", [True, False])
def test_alpha_inv_and_mask_match_jax(alpha_inv, masks):
    """The NITRO-ReLU derivative at α_inv 1 to 2²⁰, with z* over every
    segment (δ zeroed, divided, kept) and with z* in the identity segment
    only (δ kept as it is)."""
    x, delta, z = _operands((33, 130, 70), 4, 4, seed=alpha_inv % 1009 + masks, masks=masks)
    tx, td, tz = _t(x, delta, z)
    jx, jd, jz = _j(x, delta, z)
    _eq(tref.grad_w_digits(tx, td, tz, alpha_inv=alpha_inv),
        j_grad_w(jx, jd, jz, alpha_inv=alpha_inv, interpret=True),
        jref.nitro_matmul_grad_w_ref(jx, jd, jz, alpha_inv=alpha_inv))


@pytest.mark.parametrize("b", [1, 3, 33, 64, 65, 16385])
@pytest.mark.parametrize("digits", [1, 4])
def test_batch_depths_match_jax(b, digits):
    """One chunk, one and a sample, and 16,385 samples (257 chunks, each
    s32 set checked within 2^31 and folded mod 2^32), full-range operands
    included: ≡ the JAX reference."""
    x, delta, z = _operands((b, 65, 63), digits, digits, seed=b + digits)
    tx, td, tz = _t(x, delta, z)
    jx, jd, jz = _j(x, delta, z)
    _eq(tref.grad_w_digits(tx, td, tz, alpha_inv=3),
        jref.nitro_matmul_grad_w_ref(jx, jd, jz, alpha_inv=3))


#: every (B, M, N) the training paths launch: VGG8B's linear and mlp4's
#: two layer shapes at batch 64
MAIN_SHAPES = [(64, 2048, 1024), (64, 3072, 3000), (64, 3000, 3000)]


@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_main_path_shapes_match_jax(shape):
    """At the main path's digits (x in the NITRO-ReLU range: one digit;
    δ of ±170 masked: two) and at full range beside them: ≡ the JAX
    reference, for grad_W and for W′."""
    b, m, n = shape
    rng = np.random.default_rng(m + n)
    x = rng.integers(-127, 128, (b, m)).astype(np.int32)
    delta = rng.integers(-170, 171, (b, n)).astype(np.int32)
    z = rng.integers(-300, 301, (b, n)).astype(np.int32)
    w = rng.integers(-(2 ** 15), 2 ** 15, (m, n)).astype(np.int32)
    tx, td, tz, tw = _t(x, delta, z, w)
    jx, jd, jz, jw = _j(x, delta, z, w)
    _eq(tref.grad_w_digits(tx, td, tz), jref.nitro_matmul_grad_w_ref(jx, jd, jz))
    _eq(tref.grad_w_opt_digits(tx, td, tz, tw, 327680, 25000),
        _j_opt_ref(jx, jd, jz, jw, 327680, 25000, 10))
    x, delta = _ints(rng, (b, m), 4), _ints(rng, (b, n), 4)
    tx, td = _t(x, delta)
    jx, jd = _j(x, delta)
    _eq(tref.grad_w_digits(tx, td, tz), jref.nitro_matmul_grad_w_ref(jx, jd, jz))


# ---------------------------------------------------------------------------
# W′ ≡ JAX's nitro_matmul_grad_w_opt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma,eta", SGD_STATES)
@pytest.mark.parametrize("xd,gd", [(1, 2), (4, 4)])
@pytest.mark.parametrize("shape", ["B3", "B33"])
def test_opt_digits_match_jax(gamma, eta, xd, gd, shape):
    """IntegerSGD on the digit model's sums, W full range (the update
    wraps): ≡ the Pallas kernel (interpret) ≡ the JAX reference ≡ the
    port's plain version."""
    b, m, n = _SHAPES[shape]
    x, delta, z = _operands((b, m, n), xd, gd, seed=gamma % 1000 + eta + xd)
    w = _ints(np.random.default_rng(eta), (m, n), 4)
    tx, td, tz, tw = _t(x, delta, z, w)
    jx, jd, jz, jw = _j(x, delta, z, w)
    got = tref.grad_w_opt_digits(tx, td, tz, tw, gamma, eta, alpha_inv=2)
    _eq(got,
        j_grad_w_opt(jx, jd, jz, jw, jnp.int32(gamma), jnp.int32(eta), alpha_inv=2,
                     interpret=True),
        _j_opt_ref(jx, jd, jz, jw, gamma, eta, 2))
    assert torch.equal(got, tref.nitro_matmul_grad_w_opt_ref(tx, td, tz, tw, gamma, eta,
                                                             alpha_inv=2))


@settings(max_examples=40, deadline=None)
@given(
    b=st.integers(0, 140), m=st.integers(1, 140), n=st.integers(1, 80),
    xd=st.integers(1, 4), gd=st.integers(1, 4), alpha_inv=st.sampled_from([1, 2, 10]),
    state=st.sampled_from(SGD_STATES), seed=st.integers(0, 2 ** 16),
)
@example(b=0, m=1, n=1, xd=1, gd=1, alpha_inv=1, state=(1, 0), seed=0)
def test_digits_match_jax_ref(b, m, n, xd, gd, alpha_inv, state, seed):
    """Random small shapes (an empty batch included) across tiles and
    chunks: both digit models ≡ the JAX references."""
    x, delta, z = _operands((b, m, n), xd, gd, seed)
    w = _ints(np.random.default_rng(seed + 1), (m, n), 4)
    tx, td, tz, tw = _t(x, delta, z, w)
    jx, jd, jz, jw = _j(x, delta, z, w)
    _eq(tref.grad_w_digits(tx, td, tz, alpha_inv=alpha_inv),
        jref.nitro_matmul_grad_w_ref(jx, jd, jz, alpha_inv=alpha_inv))
    gamma, eta = state
    _eq(tref.grad_w_opt_digits(tx, td, tz, tw, gamma, eta, alpha_inv=alpha_inv),
        _j_opt_ref(jx, jd, jz, jw, gamma, eta, alpha_inv))


# ---------------------------------------------------------------------------
# The trajectories: vgg8b at batch 1 (split) and 3 (fuse_opt), mlp4 fuse_opt
# ---------------------------------------------------------------------------

SCALE = 0.0625


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


def _linear_digit_updates(ts, cfg, x, y, key, fuse_opt) -> dict:
    """Each linear block's grad_W (split) or W′ (``fuse_opt``) from the digit
    model, on the block's cached input, its δ as the LES step forms it and
    its z*: block index → tensor."""
    params = ts.params
    _, acts, caches, _ = TM.forward(params, cfg, x, train=True, key=key)
    y1 = one_hot_int(y, cfg.num_classes)
    out = {}
    for i, (spec, p, a_l, cache) in enumerate(zip(cfg.blocks, params["blocks"], acts, caches)):
        if spec.kind != "linear":
            continue
        y_hat, lr_cache = TB.learning_layers(p, spec, a_l)
        delta_fw, _ = TB.learning_layers_backward(p, spec, lr_cache,
                                                  TB.local_gradient(y_hat, y1))
        delta = TB.forward_layers_delta(cache, delta_fw)
        xin = cache["linear"]
        if fuse_opt:
            out[i] = tref.grad_w_opt_digits(xin, delta, cache["z_star"], p["fw"]["w"],
                                            ts.opt_fw.gamma_inv, ts.opt_fw.eta_inv,
                                            alpha_inv=spec.alpha_inv)
        else:
            out[i] = tref.grad_w_digits(xin, delta, cache["z_star"], alpha_inv=spec.alpha_inv)
    return out


@pytest.mark.parametrize("arch,batch,fuse_opt", [("vgg8b", 1, False), ("vgg8b", 3, True),
                                                 ("mlp4", 4, True)])
def test_trajectory_matches_jax(arch, batch, fuse_opt):
    """Two steps from the same keys ≡ the JAX reference trajectory (params,
    optimiser states, step, loss, correct, local losses); each step's
    linear grad_W (≡ compute_gradients') or W′ (≡ the step's new weight)
    rebuilt by the digit model."""
    tcfg, jcfg = tpaper.get(arch, scale=SCALE), jpaper.get(arch, scale=SCALE)
    ts = tles.create_train_state(prng.PRNGKey(4), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(4), jcfg)
    jstep = jax.jit(functools.partial(jles.train_step, cfg=jcfg, fuse_opt=fuse_opt,
                                      backend="reference"))
    for it in range(2):
        rng = np.random.default_rng(70 + it)
        x = rng.integers(-127, 128, (batch, *tcfg.input_shape)).astype(np.int32)
        y = rng.integers(0, tcfg.num_classes, batch).astype(np.int32)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        rebuilt = _linear_digit_updates(ts, tcfg, tx, ty, prng.PRNGKey(it), fuse_opt)
        assert rebuilt
        if not fuse_opt:
            grads, _, _ = tles.compute_gradients(ts, tcfg, tx, ty, prng.PRNGKey(it))
            for i, g in rebuilt.items():
                assert torch.equal(g, grads.blocks[i]["fw"]["w"]), i
        ts, tm = tles.train_step(ts, tcfg, tx, ty, prng.PRNGKey(it), fuse_opt=fuse_opt)
        if fuse_opt:
            for i, w in rebuilt.items():
                assert torch.equal(w, ts.params["blocks"][i]["fw"]["w"]), i
        js, jm = jstep(js, x=jnp.asarray(x), labels=jnp.asarray(y),
                       key=jax.random.PRNGKey(it))
        _eq(tm.loss, jm.loss)
        _eq(tm.correct, jm.correct)
        _eq(tm.local_losses, jm.local_losses)
        _assert_state_eq(ts, js)
