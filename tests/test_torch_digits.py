"""PyTorch port: the conv grad_W kernels' exact digit arithmetic ≡ the JAX
package, bitwise, on the CPU.

``stream_conv_grad_w`` and ``stream_conv_grad_w_opt`` run on the card as
int8 tensor-core products over signed base-256 digits of their int32
operands (``csrc_common/digit_gemm.cuh``).  Their plain model in
``repro_torch.kernels.nitro_conv.ref`` (``s8_digits``, the digit planes,
the digit-count rule and ``digit_grad_w``) is held here against the JAX
package's ``stream_conv_grad_w`` / ``stream_conv_grad_w_opt``, the Pallas
kernels in interpret mode and their references: x inside and outside
int8, δ at the int32 extremes and small enough that fewer digits run,
α_inv 1, 2 and 10, with and without z*, C = 3 and 5.  Tolerance zero,
dtype included.  The CUDA kernels themselves run only on a card:
``tests/test_torch_gpu.py``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_digits.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.kernels.nitro_conv import ops as jconv_ops
from repro.kernels.nitro_conv import ref as jconv_ref
from repro.kernels.nitro_conv.nitro_conv import stream_conv_grad_w as j_stream_conv_grad_w
from repro.kernels.nitro_conv.nitro_conv import (
    stream_conv_grad_w_opt as j_stream_conv_grad_w_opt,
)
from repro_torch.kernels.nitro_conv import ref as tref

I32 = (-(2 ** 31), 2 ** 31 - 1)


def _eq(t: torch.Tensor, *js) -> None:
    got = t.numpy()
    for j in js:
        j = np.asarray(j)
        assert got.dtype == j.dtype, (got.dtype, j.dtype)
        assert got.shape == j.shape, (got.shape, j.shape)
        np.testing.assert_array_equal(got, j)


def _ints(rng, shape, lo, hi):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


#: x ranges: the NITRO-ReLU output range (x is its own digit 0), the MAD-
#: normalised image's (several digits), the whole int32 range
X_RANGES = {"int8": (-128, 128), "int16": (-(2 ** 15), 2 ** 15), "int32": (I32[0], I32[1] + 1)}
#: δ ranges and the digits they need: one, two, three, all four (with the
#: int32 extremes planted)
D_RANGES = {"d1": (-100, 101), "d2": (-20000, 20001), "d3": (-(2 ** 20), 2 ** 20),
            "d4": (I32[0], I32[1] + 1)}


def _case(shape, x_range, d_range, seed):
    n, h, w_sp, c, f = shape
    rng = np.random.default_rng(seed)
    x = _ints(rng, (n, h, w_sp, c), *X_RANGES[x_range])
    delta = _ints(rng, (n, h, w_sp, f), *D_RANGES[d_range])
    z = _ints(rng, (n, h, w_sp, f), -300, 301)
    if x_range == "int32":
        x.flat[:2] = I32
    if d_range == "d4":
        delta.flat[:4] = [I32[0], I32[1], I32[0], I32[1]]
        z.flat[:4] = [0, 0, -5, 200]  # kept, kept, floored, zeroed
    return x, delta, z


# ---------------------------------------------------------------------------
# The digits
# ---------------------------------------------------------------------------


@settings(max_examples=80, deadline=None)
@given(v=st.lists(st.integers(*I32), min_size=1, max_size=50))
@example(v=[I32[0], I32[1], -1, 0, 1, 127, 128, -128, -129])
@example(v=[32767, -32768, 32639, 32640, -32896, -32897, 2 ** 23, -(2 ** 23)])
def test_s8_digits_are_exact(v):
    """Each digit lies in [−128, 127], the digits rebuild v mod 2^32, and
    the digit count is 1 + the highest nonzero digit (1 exactly on int8)."""
    t = torch.tensor(v, dtype=torch.int32)
    d = tref.s8_digits(t)
    assert d.dtype == torch.int8 and d.shape == (4, len(v))
    rebuilt = sum(d[i].to(torch.int64) << (8 * i) for i in range(4))
    assert torch.equal((rebuilt - t.to(torch.int64)) % 2 ** 32,
                       torch.zeros(len(v), dtype=torch.int64))
    for x in v:
        one = torch.tensor([x], dtype=torch.int32)
        need = tref.digits_needed(one)
        digits = tref.s8_digits(one)[:, 0].tolist()
        assert all(di == 0 for di in digits[need:]) and (need == 1 or digits[need - 1] != 0)
        assert (need == 1) == (-128 <= x <= 127) == tref.x_fits_s8(one)


def test_digit_count_rule_follows_the_mask():
    """The δ pre-pass counts digits of the *masked* δ: a saturated z*
    zeroes a wide δ, and a negative z* floors it by α_inv."""
    delta = torch.tensor([[I32[0], -5001, 5]], dtype=torch.int32)
    z_sat = torch.tensor([[200, -5, 0]], dtype=torch.int32)
    planes, nd = tref.delta_digit_planes(delta, z_sat, alpha_inv=10)
    assert nd == 2 and planes.shape == (4, 3, tref.PIXEL_TILE)  # 0, −501, 5
    assert not planes[:, :, 1:].any()  # the pixel padding is zero
    _, nd = tref.delta_digit_planes(delta)
    assert nd == 4
    _, nd = tref.delta_digit_planes(torch.zeros((2, 3), dtype=torch.int32))
    assert nd == 1


@pytest.mark.parametrize("d_range", sorted(D_RANGES))
def test_fewer_digit_products_are_exact(d_range):
    """Running only the products the digit count asks for gives the same
    bits as all ten pairs i + j ≤ 3."""
    x, delta, z = _case((2, 5, 6, 3, 7), "int32", d_range, seed=len(d_range) + 17)
    xa = tref.patch_digit_planes(torch.from_numpy(x), 3)
    db, nd = tref.delta_digit_planes(torch.from_numpy(delta), torch.from_numpy(z), 10)
    assert nd == int(d_range[1]) and xa.shape[0] == 4
    assert torch.equal(tref.digit_grad_w(xa, db, nd), tref.digit_grad_w(xa, db, 4))


# ---------------------------------------------------------------------------
# The digit-product grad_W ≡ JAX's stream_conv_grad_w
# ---------------------------------------------------------------------------

_SHAPES = {"C3": (2, 7, 9, 3, 10), "C5": (1, 6, 5, 5, 33)}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("x_range", sorted(X_RANGES))
@pytest.mark.parametrize("d_range", ["d1", "d3", "d4"])
@pytest.mark.parametrize("alpha_inv,with_z", [(1, True), (2, True), (10, True), (10, False)])
def test_digit_grad_w_matches_jax(shape, x_range, d_range, alpha_inv, with_z):
    """The digit model ≡ the Pallas kernel (interpret) ≡ the JAX reference,
    K = 3, and ≡ the port's band oracle."""
    x, delta, z = _case(_SHAPES[shape], x_range, d_range,
                        seed=sum(_SHAPES[shape]) + alpha_inv + len(x_range) + with_z)
    tz, jz = (torch.from_numpy(z), jnp.asarray(z)) if with_z else (None, None)
    got = tref.stream_conv_grad_w_digits(torch.from_numpy(x), torch.from_numpy(delta),
                                         kernel_size=3, z_star=tz, alpha_inv=alpha_inv)
    jx, jd = jnp.asarray(x), jnp.asarray(delta)
    _eq(got,
        j_stream_conv_grad_w(jx, jd, kernel_size=3, z_star=jz, alpha_inv=alpha_inv,
                             interpret=True),
        jconv_ref.stream_conv_grad_w_ref(jx, jd, kernel_size=3, z_star=jz,
                                         alpha_inv=alpha_inv))
    assert torch.equal(got, tref.stream_conv_grad_w_ref(
        torch.from_numpy(x), torch.from_numpy(delta), kernel_size=3, z_star=tz,
        alpha_inv=alpha_inv))


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(1, 3), h=st.integers(1, 7), w_sp=st.integers(1, 7),
    c=st.sampled_from([3, 5]), f=st.integers(1, 9), k=st.sampled_from([1, 3, 5]),
    x_range=st.sampled_from(sorted(X_RANGES)), d_range=st.sampled_from(sorted(D_RANGES)),
    alpha_inv=st.sampled_from([1, 2, 10]), with_z=st.booleans(),
    seed=st.integers(0, 2 ** 16),
)
@example(n=1, h=1, w_sp=1, c=3, f=1, k=5, x_range="int32", d_range="d4", alpha_inv=1,
         with_z=False, seed=0)
def test_digit_grad_w_matches_jax_ref(n, h, w_sp, c, f, k, x_range, d_range, alpha_inv,
                                      with_z, seed):
    """Random shapes (a halo wider than the image included) ≡ the JAX
    reference."""
    x, delta, z = _case((n, h, w_sp, c, f), x_range, d_range, seed)
    tz, jz = (torch.from_numpy(z), jnp.asarray(z)) if with_z else (None, None)
    got = tref.stream_conv_grad_w_digits(torch.from_numpy(x), torch.from_numpy(delta),
                                         kernel_size=k, z_star=tz, alpha_inv=alpha_inv)
    _eq(got, jconv_ref.stream_conv_grad_w_ref(jnp.asarray(x), jnp.asarray(delta),
                                              kernel_size=k, z_star=jz,
                                              alpha_inv=alpha_inv))


# ---------------------------------------------------------------------------
# The digit-product update ≡ JAX's stream_conv_grad_w_opt
# ---------------------------------------------------------------------------

# (γ_inv, η_inv): the forward layers' AF-amplified γ with decay, γ_inv = 1
# without decay, a negative γ_inv
_STATES = [(512 * 640, 12000), (1, 0), (-3, 5)]


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("x_range,d_range", [("int8", "d3"), ("int32", "d4"),
                                             ("int16", "d1")])
@pytest.mark.parametrize("gamma,eta", _STATES)
@pytest.mark.parametrize("alpha_inv", [1, 10])
def test_digit_grad_w_opt_matches_jax(shape, x_range, d_range, gamma, eta, alpha_inv):
    """W′ from the digit model ≡ the Pallas update kernel (interpret) ≡
    the JAX dispatcher's reference, on full-range W."""
    x, delta, z = _case(_SHAPES[shape], x_range, d_range,
                        seed=sum(_SHAPES[shape]) + gamma % 97 + alpha_inv)
    c, f = _SHAPES[shape][3], _SHAPES[shape][4]
    w = _ints(np.random.default_rng(gamma % 89), (3, 3, c, f), I32[0], I32[1] + 1)
    got = tref.stream_conv_grad_w_opt_digits(
        *(torch.from_numpy(a) for a in (x, delta, z, w)), gamma, eta, kernel_size=3,
        alpha_inv=alpha_inv)
    jx, jd, jz, jw = (jnp.asarray(a) for a in (x, delta, z, w))
    _eq(got,
        j_stream_conv_grad_w_opt(jx, jd, jz, jw, jnp.int32(gamma), jnp.int32(eta),
                                 kernel_size=3, alpha_inv=alpha_inv, interpret=True),
        jconv_ops.conv_grad_w_opt(jx, jd, jw, gamma, eta, kernel_size=3, z_star=jz,
                                  alpha_inv=alpha_inv, backend="reference"))
