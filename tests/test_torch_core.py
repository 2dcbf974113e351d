"""PyTorch port, integer foundations: ``repro_torch.core`` ≡ ``repro.core``.

Every value is an integer, so the tolerance is zero: the same numpy inputs
go through the JAX function and its port, and the results must be equal,
dtype included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import activations as jact
from repro.core import init as jinit
from repro.core import numerics as jnum
from repro.core import scaling as jscale
from repro_torch.configs import paper as tpaper
from repro_torch.core import activations as tact
from repro_torch.core import init as tinit
from repro_torch.core import numerics as tnum
from repro_torch.core import prng
from repro_torch.core import scaling as tscale


def _eq(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    got = t.numpy()
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    np.testing.assert_array_equal(got, j)


def _range(seed=0, n=4000, lo=-(2 ** 20), hi=2 ** 20):
    """Negative-heavy integers incl. every value near 0 and the int8 edges."""
    rng = np.random.default_rng(seed)
    edge = np.arange(-300, 301)
    return np.concatenate([edge, rng.integers(lo, hi, n)]).astype(np.int32)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 10, 27, 256, 6912, 2 ** 19])
def test_floor_div(d):
    x = _range(d)
    _eq(tnum.floor_div(torch.from_numpy(x), d), jnum.floor_div(jnp.asarray(x), d))


def test_isqrt():
    n = np.concatenate([np.arange(0, 2000), [2 ** 31 - 1, 46340 ** 2, 46341 ** 2 - 1],
                        np.random.default_rng(1).integers(0, 2 ** 31 - 1, 500),
                        [-5, -1]]).astype(np.int32)
    _eq(tnum.isqrt(torch.from_numpy(n)), jnum.isqrt(jnp.asarray(n)))


def test_bitwidth_bound():
    for xb, wb, fan in [(8, 8, 1), (8, 8, 27), (8, 16, 1152), (32, 8, 4608)]:
        assert tnum.bitwidth_bound(xb, wb, fan) == jnum.bitwidth_bound(xb, wb, fan)


@pytest.mark.parametrize("sf", [1, 3, 12, 256 * 27, 256 * 1152, 2 ** 19, 9 << 17])
def test_scale_forward_and_pow2_split(sf):
    z = _range(sf, lo=-(2 ** 31), hi=2 ** 31 - 1)
    _eq(tscale.scale_forward(torch.from_numpy(z), sf),
        jscale.scale_forward(jnp.asarray(z), sf))
    assert tscale.pow2_split(sf) == jscale.pow2_split(sf)


def test_scale_factors():
    for k, c in [(3, 3), (3, 128), (5, 7), (1, 1)]:
        assert tscale.conv_scale_factor(k, c) == jscale.conv_scale_factor(k, c)
    for m in (1, 784, 2048):
        assert tscale.linear_scale_factor(m) == jscale.linear_scale_factor(m)


@pytest.mark.parametrize("alpha_inv", [1, 2, 3, 10, 127])
def test_relu_constants(alpha_inv):
    assert tact.segment_means(alpha_inv) == jact.segment_means(alpha_inv)
    assert tact.mu_int8(alpha_inv) == jact.mu_int8(alpha_inv)
    assert tact.relu_fits_int8(alpha_inv) == jact.relu_fits_int8(alpha_inv)


@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
def test_nitro_relu(alpha_inv):
    z = _range(alpha_inv, lo=-5000, hi=5000)
    _eq(tact.nitro_relu(torch.from_numpy(z), alpha_inv),
        jact.nitro_relu(jnp.asarray(z), alpha_inv))


def test_int_matmul_wraps_like_xla_and_lifts_int8():
    """int8 @ int8 on torch CPU returns int8 and wraps; int_matmul lifts."""
    rng = np.random.default_rng(3)
    x8 = rng.integers(-127, 128, (4, 300)).astype(np.int8)
    w8 = rng.integers(-127, 128, (300, 5)).astype(np.int8)
    _eq(tnum.int_matmul(torch.from_numpy(x8), torch.from_numpy(w8)),
        jnum.int_matmul(jnp.asarray(x8), jnp.asarray(w8)))
    big = rng.integers(-(2 ** 31), 2 ** 31 - 1, (3, 64)).astype(np.int32)
    wbig = rng.integers(-(2 ** 31), 2 ** 31 - 1, (64, 4)).astype(np.int32)
    want = jnum.int_matmul(jnp.asarray(big), jnp.asarray(wbig))
    _eq(tnum.int_matmul(torch.from_numpy(big), torch.from_numpy(wbig)), want)
    # the exact float64-limb product the plain path uses off the CPU
    _eq(tnum._matmul_f64_exact(torch.from_numpy(big), torch.from_numpy(wbig)), want)


def _fan_ins(cfg):
    fans, shape = [], cfg.input_shape
    for spec in cfg.blocks:
        if spec.kind == "conv":
            fans.append(spec.kernel_size ** 2 * shape[-1])
            h, w = (shape[0] // 2, shape[1] // 2) if spec.pool else shape[:2]
            shape = (h, w, spec.out_features)
        else:
            fans.append(int(np.prod(shape)))
            shape = (spec.out_features,)
    return fans + [int(np.prod(shape)), 4096, 1024, 512, 128, 10]


@pytest.mark.parametrize("arch", ["vgg8b", "vgg11b"])
def test_kaiming_bound_every_fan_in(arch):
    for fan in _fan_ins(tpaper.get(arch)):
        assert tinit.kaiming_bound(fan) == jinit.kaiming_bound(fan), fan


def test_integer_kaiming_uniform_range_and_generator():
    """Drawn from a threefry key: in [-b, b], reproducible, and the JAX
    package's draw for the same key."""
    w = tinit.integer_kaiming_uniform(prng.PRNGKey(0), (3, 3, 128, 256), 1152)
    b = jinit.kaiming_bound(1152)
    assert w.dtype == torch.int32 and w.shape == (3, 3, 128, 256)
    assert int(w.min()) == -b and int(w.max()) == b
    w2 = tinit.integer_kaiming_uniform(prng.PRNGKey(0), (3, 3, 128, 256), 1152)
    assert torch.equal(w, w2)
    _eq(w, jinit.integer_kaiming_uniform(jax.random.PRNGKey(0), (3, 3, 128, 256), 1152))


@pytest.mark.parametrize("arch,scale", [("vgg8b", 1.0), ("vgg11b", 0.25),
                                        ("mlp4", 0.0625), ("mlp1", 1.0)])
def test_paper_configs_match(arch, scale):
    t, j = tpaper.get(arch, scale=scale), jpaper.get(arch, scale=scale)
    assert t.input_shape == j.input_shape and t.num_classes == j.num_classes
    assert (t.gamma_inv, t.eta_fw, t.eta_lr, t.name) == (j.gamma_inv, j.eta_fw, j.eta_lr, j.name)
    assert [vars(b) for b in t.blocks] == [vars(b) for b in j.blocks]
