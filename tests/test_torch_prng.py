"""PyTorch port, threefry random numbers: ``repro_torch.core.prng`` ≡
``jax.random`` bit for bit, and the port's init ≡ the JAX package's.

``jax.random`` keys and words are uint32; the port holds them as int64
values in [0, 2³²) (torch's uint32 has little arithmetic), so those
tests check the range and compare the values as uint32.  ``randint`` is
int32 on both sides and is compared dtype and all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import init as jinit
from repro.core import model as JM
from repro_torch.configs import paper as tpaper
from repro_torch.core import init as tinit
from repro_torch.core import model as TM
from repro_torch.core import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1, -5]


def _words(t: torch.Tensor, j) -> None:
    """Port words (int64 in [0, 2³²)) ≡ JAX uint32 words."""
    j = np.asarray(j)
    assert j.dtype == np.uint32
    got = t.numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2 ** 32
    assert np.array_equal(got.astype(np.uint32), j)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    _words(prng.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 7, 10])
def test_split(seed, n):
    _words(prng.split(prng.PRNGKey(seed), n), jax.random.split(jax.random.PRNGKey(seed), n))


def test_split_of_split_rows():
    k, jk = prng.PRNGKey(9), jax.random.PRNGKey(9)
    for _ in range(3):
        k, jk = prng.split(k, 3)[2], jax.random.split(jk, 3)[2]
        _words(k, jk)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (2, 3, 5), (64, 33), (4, 1, 1, 9)])
def test_bits(seed, shape):
    _words(prng.bits(prng.PRNGKey(seed), shape),
           jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("lo,hi", [
    (-44, 45), (0, 10), (-6, 7), (-221, 222),
    (0, 65535), (0, 65536), (0, 65537), (-100, 70000),   # around span = 2¹⁶
    (-(2 ** 30), 2 ** 30), (-(2 ** 31), 2 ** 31 - 1),    # wide spans wrap
    (5, 5), (7, 3),                                      # empty span → lo
])
@pytest.mark.parametrize("shape", [(17,), (3, 3, 3, 128)])
def test_randint(seed, lo, hi, shape):
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi).numpy()
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi, jnp.int32))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_randint_large_linear_weight_shape():
    """The VGG8B linear block's (2048, 1024) weight draw."""
    key = jax.random.split(jax.random.PRNGKey(0), 3)[1]
    got = prng.randint(prng.split(prng.PRNGKey(0), 3)[1], (2048, 1024), -6, 7).numpy()
    want = np.asarray(jax.random.randint(key, (2048, 1024), -6, 7, jnp.int32))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_bad_keys_and_bounds_raise():
    with pytest.raises(ValueError, match="does not fit int32"):
        prng.PRNGKey(2 ** 31)
    with pytest.raises(ValueError, match="shape"):
        prng.bits(torch.zeros(3, dtype=torch.int64), (2,))
    with pytest.raises(ValueError, match="must fit int32"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2 ** 31)


@pytest.mark.parametrize("seed,fan_in,shape", [
    (0, 27, (3, 3, 3, 128)), (3, 1152, (3, 3, 128, 256)), (5, 2048, (2048, 10)),
])
def test_integer_kaiming_uniform_matches_jax(seed, fan_in, shape):
    got = tinit.integer_kaiming_uniform(prng.PRNGKey(seed), shape, fan_in).numpy()
    want = np.asarray(jinit.integer_kaiming_uniform(jax.random.PRNGKey(seed), shape, fan_in))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _leaves(params) -> list[np.ndarray]:
    return ([b[k]["w"].numpy() for b in params["blocks"] for k in ("fw", "lr")]
            + [params["output"]["w"].numpy()])


@pytest.mark.parametrize("arch,scale,seed", [("vgg8b", 1.0, 0), ("vgg11b", 0.25, 3),
                                             ("mlp1", 1.0, 1)])
def test_init_params_matches_jax(arch, scale, seed):
    """init_params(PRNGKey(s), cfg) ≡ the JAX init, every leaf (full-width
    VGG8B included)."""
    got = _leaves(TM.init_params(prng.PRNGKey(seed), tpaper.get(arch, scale=scale),
                                 device="cpu"))
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        JM.init_params(jax.random.PRNGKey(seed), jpaper.get(arch, scale=scale)))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
