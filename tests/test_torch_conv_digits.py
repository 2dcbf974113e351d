"""PyTorch port: the forward conv kernels' exact digit arithmetic ≡ the JAX
package, bitwise, on the CPU.

``stream_conv`` and ``stream_conv_fwd`` run on the card as int8
tensor-core products over signed base-256 digits of x and w
(``csrc_common/conv_digits.cuh``).  Their plain model in
``repro_torch.kernels.nitro_conv.ref`` (``x_digit_planes``,
``w_digit_planes``, ``conv_digit_rows``, ``digit_conv``,
``stream_conv_digits`` and ``stream_conv_fwd_digits``) is held here against
the JAX package's ``stream_conv`` / ``stream_conv_fwd``, the Pallas kernels
in interpret mode and their references: x in int8, int16 and the whole
int32 range (INT32_MIN/MAX planted), w of one, two and four digits,
α_inv 1, 2 and 10, the ReLU on and off, the pool on and off with odd H and
W, int8 and int32 outputs, sf = 1 and a non-power-of-two sf, C = 1, 3, 5
(the patch planes) and 16 (the NHWC planes), K = 1, 3 and 5, a contraction
deep enough to fold, and VGG8B at the digits28 input.  Tolerance zero,
dtype included.  The CUDA kernels themselves run only on a card:
``tests/test_torch_gpu.py``.

    PYTHONPATH=src python -m pytest -q -n 4 tests/test_torch_conv_digits.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import paper as jpaper
from repro.core import model as JM
from repro.infer import compile_plan as j_compile_plan
from repro.infer import freeze as j_freeze
from repro.kernels.nitro_conv import ref as jconv_ref
from repro.kernels.nitro_conv.nitro_conv import stream_conv as j_stream_conv
from repro.kernels.nitro_conv.nitro_conv import stream_conv_fwd as j_stream_conv_fwd
from repro_torch.configs import paper as tpaper
from repro_torch.core import model as TM
from repro_torch.core import prng
from repro_torch.core.scaling import conv_scale_factor
from repro_torch.infer import compile_plan, freeze
from repro_torch.kernels.nitro_conv import ref as tref
from repro_torch.kernels.nitro_conv.ops import fused_conv

I32 = (-(2 ** 31), 2 ** 31 - 1)
_T = {"int8": torch.int8, "int32": torch.int32}
_J = {"int8": jnp.int8, "int32": jnp.int32}


def _eq(t: torch.Tensor, *js) -> None:
    got = t.numpy()
    for j in js:
        j = np.asarray(j)
        assert got.dtype == j.dtype, (got.dtype, j.dtype)
        assert got.shape == j.shape, (got.shape, j.shape)
        np.testing.assert_array_equal(got, j)


def _ints(rng, shape, lo, hi, dtype=np.int32):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(dtype)


#: x ranges and dtypes: the NITRO-ReLU output range as int8 (x is its own
#: digit plane), the int16 range (two or three digits, as the MAD-normalised
#: image's), the whole int32 range (four, with the extremes planted)
X_RANGES = {"int8": (-128, 128, np.int8), "int16": (-(2 ** 15), 2 ** 15, np.int16),
            "int32": (I32[0], I32[1] + 1, np.int32)}
#: w ranges and the digits they need: one (as int32), two, all four (with
#: the extremes planted)
W_RANGES = {"w1": (-100, 101), "w2": (-20000, 20001), "w4": (I32[0], I32[1] + 1)}


def _case(shape, k, x_range, w_range, seed):
    """x (its range's dtype) and w (int32) from a numpy seed."""
    n, h, w_sp, c, f = shape
    rng = np.random.default_rng(seed)
    lo, hi, dt = X_RANGES[x_range]
    x = _ints(rng, (n, h, w_sp, c), lo, hi, dt)
    w = _ints(rng, (k, k, c, f), *W_RANGES[w_range])
    if x_range == "int32":
        x.flat[:2] = I32
    if w_range == "w4":
        w.flat[:2] = I32[::-1]
    return x, w


def _jax_pair(x, w):
    """The same values for JAX: int32 unless both are int8."""
    if x.dtype == np.int8 and w.dtype == np.int8:
        return jnp.asarray(x), jnp.asarray(w)
    return jnp.asarray(x.astype(np.int32)), jnp.asarray(w.astype(np.int32))


# ---------------------------------------------------------------------------
# The planes, the digit counts and the row order
# ---------------------------------------------------------------------------


def test_x_planes_nhwc_patch_and_int8():
    """16 | C: NHWC planes of x's own digits (an int8 x is its own one
    plane); else the patch matrix's planes, K²C zero-padded to 64."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_ints(rng, (2, 3, 4, 16), -300, 300))
    planes, nd, patch = tref.x_digit_planes(x, 3)
    assert not patch and nd == 2 and planes.shape == (4, 24, 16)
    rebuilt = sum(planes[i].to(torch.int64) << (8 * i) for i in range(4))
    assert torch.equal(rebuilt.to(torch.int32), x.reshape(24, 16))
    x8 = x.clamp(-128, 127).to(torch.int8)
    planes, nd, patch = tref.x_digit_planes(x8, 3)
    assert nd == 1 and planes.shape == (1, 24, 16) and torch.equal(planes[0], x8.reshape(24, 16))
    xr = torch.from_numpy(_ints(rng, (2, 3, 4, 3), -100, 100))
    planes, nd, patch = tref.x_digit_planes(xr, 3)
    assert patch and nd == 1 and planes.shape == (4, 24, 64)
    assert not planes[:, :, 27:].any() and not planes[1:].any()
    # the centre tap (ki = kj = 1) of every patch is the pixel itself
    assert torch.equal(planes[0][:, 12:15].to(torch.int32), xr.reshape(24, 3))


def test_w_planes_transposed_and_counted():
    """w (K,K,C,F) → four (F, K²C padded to 64) planes; its digit count."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(_ints(rng, (3, 3, 5, 7), -20000, 20001))
    planes, nd = tref.w_digit_planes(w)
    assert nd == 2 and planes.shape == (4, 7, 64) and not planes[:, :, 45:].any()
    rebuilt = sum(planes[i, :, :45].to(torch.int64) << (8 * i) for i in range(4))
    assert torch.equal(rebuilt.to(torch.int32).T, w.reshape(45, 7))
    assert tref.w_digit_planes(torch.full((1, 1, 1, 2), 127, dtype=torch.int32))[1] == 1
    assert tref.w_digit_planes(torch.full((1, 1, 1, 2), 128, dtype=torch.int32))[1] == 2
    assert tref.w_digit_planes(torch.tensor([[[[I32[0]]]]], dtype=torch.int32))[1] == 4


@pytest.mark.parametrize("h,w_sp", [(4, 6), (5, 7), (2, 3)])
def test_pool_rows_are_windows(h, w_sp):
    """With the pool, rows 4q..4q+3 are window q's pixels (dy, dx) in
    order, windows in (n, h/2, w/2) order; the crop has no row."""
    rows = tref.conv_digit_rows(2, h, w_sp, pool=True)
    h2, w2 = h // 2, w_sp // 2
    assert rows.shape == (4 * 2 * h2 * w2,)
    want = [(n * h + 2 * i + dy) * w_sp + 2 * j + dx
            for n in range(2) for i in range(h2) for j in range(w2)
            for dy in range(2) for dx in range(2)]
    assert rows.tolist() == want
    assert torch.equal(tref.conv_digit_rows(2, h, w_sp, pool=False), torch.arange(2 * h * w_sp))


@pytest.mark.parametrize("x_range", sorted(X_RANGES))
@pytest.mark.parametrize("w_range", sorted(W_RANGES))
def test_fewer_digit_products_are_exact(x_range, w_range):
    """The digit counts are the data's, and the products they ask for
    give the plain version's bits."""
    x, w = _case((2, 4, 5, 16, 6), 3, x_range, w_range, seed=len(x_range + w_range))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    _, nx, _ = tref.x_digit_planes(tx, 3)
    _, nw = tref.w_digit_planes(tw)
    # balanced digits: [−128, 127] needs one, [−32,896, 32,639] two (so
    # the int16 range needs three at its ends), INT32_MIN four
    two = -32896 <= x.min() and x.max() <= 32639
    assert nx == {"int8": 1, "int16": 2 if two else 3, "int32": 4}[x_range]
    assert nw == int(w_range[1])
    got = tref.digit_conv(tx, tw)
    want = tref.stream_conv_fwd_ref(tx.to(torch.int32), tw, sf=1)[1].reshape(-1, 6)
    assert torch.equal(got, want)


def test_fold_keeps_a_deep_contraction_exact():
    """K²C = 18,432 > 16,384: two slices, each within the s32 bound,
    combined mod 2^32 — ≡ the JAX reference on full-range x and w."""
    x, w = _case((1, 3, 2, 2048, 3), 3, "int32", "w4", seed=5)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert 16384 < 9 * 2048 <= 2 * tref.FOLD_COLS
    got = tref.stream_conv_fwd_digits(tx, tw, sf=3 << 9, alpha_inv=10)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    ja, jz = jconv_ref.stream_conv_fwd_ref(jx, jw, sf=3 << 9, alpha_inv=10)
    _eq(got[0], ja)
    _eq(got[1], jz)


# ---------------------------------------------------------------------------
# The digit-product forward ≡ JAX's stream_conv_fwd
# ---------------------------------------------------------------------------

#: (N, H, W, C, F, K): C = 1 and 3 (patch planes, conv 1 and digits28),
#: 5 with K = 5, 16 with K = 1 and 3 (NHWC planes)
_SHAPES = {"C1K3": (2, 6, 5, 1, 9, 3), "C3K3": (2, 7, 5, 3, 10, 3), "C5K5": (1, 6, 7, 5, 7, 5),
           "C16K1": (2, 5, 6, 16, 9, 1), "C16K3": (1, 5, 7, 16, 20, 3)}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("x_range,w_range", [("int8", "w1"), ("int16", "w2"),
                                             ("int32", "w4"), ("int8", "w4")])
@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
def test_fwd_digits_match_jax(shape, x_range, w_range, alpha_inv):
    """(a, z*) of the digit model ≡ the Pallas kernel (interpret) ≡ the JAX
    reference ≡ the port's band oracle, sf not a power of two."""
    *dims, k = _SHAPES[shape]
    x, w = _case(dims, k, x_range, w_range, seed=sum(dims) + alpha_inv + len(x_range))
    sf = 3 << 9
    got = tref.stream_conv_fwd_digits(torch.from_numpy(x), torch.from_numpy(w), sf=sf,
                                      alpha_inv=alpha_inv)
    jx, jw = _jax_pair(x, w)
    ja, jz = j_stream_conv_fwd(jx, jw, sf=sf, alpha_inv=alpha_inv, interpret=True)
    ra, rz = jconv_ref.stream_conv_fwd_ref(jx, jw, sf=sf, alpha_inv=alpha_inv)
    _eq(got[0], ja, ra)
    _eq(got[1], jz, rz)
    ta, tz = tref.stream_conv_fwd_ref(torch.from_numpy(x), torch.from_numpy(w), sf=sf,
                                      alpha_inv=alpha_inv)
    assert torch.equal(got[0], ta) and torch.equal(got[1], tz)


# ---------------------------------------------------------------------------
# The digit-product serving conv ≡ JAX's stream_conv
# ---------------------------------------------------------------------------

_SERVE_SHAPES = {"C1K3odd": (2, 7, 5, 1, 9, 3), "C3K3": (2, 6, 6, 3, 10, 3),
                 "C5K5odd": (1, 5, 7, 5, 7, 5), "C16K1odd": (2, 5, 7, 16, 9, 1),
                 "C16K3": (1, 6, 8, 16, 20, 3)}


@pytest.mark.parametrize("shape", sorted(_SERVE_SHAPES))
@pytest.mark.parametrize("x_range,w_range", [("int8", "w1"), ("int16", "w2"),
                                             ("int32", "w4")])
@pytest.mark.parametrize("relu,pool,out", [(True, True, "int8"), (True, False, "int32"),
                                           (False, True, "int32"), (False, False, "int8")])
@pytest.mark.parametrize("sf", [1, 3 << 9])
def test_serve_digits_match_jax(shape, x_range, w_range, relu, pool, out, sf):
    """The digit model ≡ the Pallas kernel (interpret) ≡ the JAX reference,
    ReLU and pool on and off (odd H or W cropped), int8 and int32 out."""
    *dims, k = _SERVE_SHAPES[shape]
    x, w = _case(dims, k, x_range, w_range, seed=sum(dims) + sf % 7 + len(x_range))
    kw = dict(sf=sf, alpha_inv=10, apply_relu=relu, pool=pool)
    got = tref.stream_conv_digits(torch.from_numpy(x), torch.from_numpy(w),
                                  out_dtype=_T[out], **kw)
    jx, jw = _jax_pair(x, w)
    _eq(got,
        j_stream_conv(jx, jw, out_dtype=_J[out], interpret=True, **kw),
        jconv_ref.stream_conv_ref(jx, jw, out_dtype=_J[out], **kw))
    assert torch.equal(got, tref.stream_conv_ref(torch.from_numpy(x), torch.from_numpy(w),
                                                 out_dtype=_T[out], **kw))


@pytest.mark.parametrize("shape", ["C3K3", "C16K3"])
@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
def test_int8_operands_match_jax(shape, alpha_inv):
    """The serving plan's int8 steps: int8 x and w (x its own plane, one
    product) ≡ JAX's int8-operand kernel, pooled to int8."""
    *dims, k = _SERVE_SHAPES[shape]
    n, h, w_sp, c, f = dims
    rng = np.random.default_rng(alpha_inv + c)
    x = _ints(rng, (n, h, w_sp, c), -128, 128, np.int8)
    w = _ints(rng, (k, k, c, f), -128, 128, np.int8)
    kw = dict(sf=3 << 9, alpha_inv=alpha_inv, pool=True, out_dtype=jnp.int8)
    got = tref.stream_conv_digits(torch.from_numpy(x), torch.from_numpy(w),
                                  **{**kw, "out_dtype": torch.int8})
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    _eq(got, j_stream_conv(jx, jw, operand_dtype="int8", interpret=True, **kw),
        jconv_ref.stream_conv_ref(jx, jw, operand_dtype="int8", **kw))


@settings(max_examples=40, deadline=None)
@given(
    n=st.integers(1, 3), h=st.integers(2, 7), w_sp=st.integers(2, 7),
    c=st.sampled_from([1, 3, 5, 16]), f=st.integers(1, 9), k=st.sampled_from([1, 3, 5]),
    x_range=st.sampled_from(sorted(X_RANGES)), w_range=st.sampled_from(sorted(W_RANGES)),
    relu=st.booleans(), pool=st.booleans(), out=st.sampled_from(sorted(_T)),
    sf=st.sampled_from([1, 2, 3 << 9, 27 << 8]), alpha_inv=st.sampled_from([1, 2, 10]),
    seed=st.integers(0, 2 ** 16),
)
@example(n=1, h=2, w_sp=2, c=1, f=1, k=5, x_range="int32", w_range="w4", relu=False,
         pool=True, out="int32", sf=1, alpha_inv=1, seed=0)
def test_digits_match_jax_ref(n, h, w_sp, c, f, k, x_range, w_range, relu, pool, out, sf,
                              alpha_inv, seed):
    """Random small shapes (a halo wider than the image included): both
    digit models ≡ the JAX references."""
    x, w = _case((n, h, w_sp, c, f), k, x_range, w_range, seed)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = _jax_pair(x, w)
    kw = dict(sf=sf, alpha_inv=alpha_inv, apply_relu=relu, pool=pool)
    _eq(tref.stream_conv_digits(tx, tw, out_dtype=_T[out], **kw),
        jconv_ref.stream_conv_ref(jx, jw, out_dtype=_J[out], **kw))
    a, z = tref.stream_conv_fwd_digits(tx, tw, sf=sf, alpha_inv=alpha_inv)
    ja, jz = jconv_ref.stream_conv_fwd_ref(jx, jw, sf=sf, alpha_inv=alpha_inv)
    _eq(a, ja)
    _eq(z, jz)


# ---------------------------------------------------------------------------
# VGG8B at the digits28 input (28, 28, 1), reduced scale
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def digits28():
    """VGG8B at scale 1/16 for (28, 28, 1): JAX config and params, the
    port's config and params, and a batch in the normalised image range."""
    jcfg = jpaper.get("vgg8b", scale=0.0625, input_shape=(28, 28, 1))
    jparams = JM.init_params(jax.random.PRNGKey(4), jcfg)
    cfg = tpaper.get("vgg8b", scale=0.0625, input_shape=(28, 28, 1))
    params = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    x = np.random.default_rng(4).integers(-600, 600, (3, 28, 28, 1)).astype(np.int32)
    return jcfg, jparams, cfg, params, x


def test_vgg8b_digits28_forward_matches_jax(digits28):
    """The training forward with caches ≡ JAX's, block by block, and each
    conv's (a, z*) from the digit model ≡ the cached z* and its ReLU."""
    jcfg, jparams, cfg, params, x = digits28
    _, jacts, jcaches, _ = JM.forward(jparams, jcfg, jnp.asarray(x), train=True,
                                      key=jax.random.PRNGKey(9))
    _, acts, caches, _ = TM.forward(params, cfg, x, train=True, key=prng.PRNGKey(9))
    convs = 0
    for spec, p, a, ja, cache, jcache in zip(cfg.blocks, params["blocks"], acts, jacts,
                                             caches, jcaches):
        _eq(a, ja)
        _eq(cache["z_star"], jcache["z_star"])
        if spec.kind == "conv":
            xin = cache["conv"].x
            sf = conv_scale_factor(spec.kernel_size, xin.shape[-1])
            da, dz = tref.stream_conv_fwd_digits(xin, p["fw"]["w"], sf=sf,
                                                 alpha_inv=spec.alpha_inv)
            _eq(dz, jcache["z_star"])
            assert torch.equal(da, tref.stream_conv_fwd_ref(
                xin, p["fw"]["w"], sf=sf, alpha_inv=spec.alpha_inv)[0])
            convs += 1
    assert convs == 6 and cfg.blocks[0].kind == "conv"


def test_vgg8b_digits28_plan_matches_jax(digits28):
    """The served plan's logits ≡ JAX's reference plan's, and every conv
    step through the digit model ≡ the plan's step on the same input."""
    jcfg, jparams, cfg, params, x = digits28
    plan = compile_plan(freeze(params, cfg), device="cpu")
    jplan = j_compile_plan(j_freeze(jparams, jcfg), backend="reference")
    _eq(plan.logits(x), jplan.logits(jnp.asarray(x)))
    a = torch.from_numpy(x)
    ops = []
    for w, meta in zip(plan.weights, plan.metas):
        if meta.kind != "conv":
            break
        kw = dict(sf=meta.sf, alpha_inv=meta.alpha_inv, apply_relu=meta.apply_relu,
                  pool=meta.pool, out_dtype=_T[meta.out_dtype])
        want = fused_conv(a, w, backend="reference", operand_dtype=meta.operand_dtype, **kw)
        assert torch.equal(tref.stream_conv_digits(a, w, **kw), want)
        ops.append(meta.operand_dtype)
        a = want
    assert ops == ["int32"] + ["int8"] * 5
