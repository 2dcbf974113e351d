"""PyTorch port, the input-gradient kernels' digit arithmetic ≡ the JAX
package's input gradients, bitwise, on the CPU.

``stream_conv_grad_x`` and ``nitro_matmul_grad_x`` run on the int8 tensor
cores over exact signed base-256 digits of the masked δ and of w.  Their
plain models (``nitro_conv/ref.py``: ``rot_w_digit_planes``,
``stream_conv_grad_x_digits``; ``nitro_matmul/ref.py``:
``grad_x_w_planes``, ``nitro_matmul_grad_x_digits``) do what the kernels
do — the masked pre-passes, the rotated weight's planes read from w as it
lies, w split into digits with a count per warp step, only the digit
pairs the counts allow, the fold every 16,384 columns, the split plan and
its last-arrival sum — and are held here against the JAX package's Pallas
kernels in interpret mode and its references: on every (δ digits, w
digits) variant, α_inv 1, 2 and 10, full-range int32 operands (the sums
wrap), F % 16 != 0 and C = 3, odd batches, a contraction deeper than
16,384 and split plans with more splits than tiles; then a small-width
VGG8B and an mlp4-shaped grad_x pass through ``layers.*_backward`` /
``*_update`` against JAX's.  The same numpy inputs go through both sides;
tolerance zero, dtype included.  The CUDA kernels themselves run only on
a card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as jlayers
from repro.core import optimizer as jopt
from repro.kernels.nitro_conv import nitro_conv as jconv_kernels
from repro.kernels.nitro_conv import ref as jconv_ref
from repro.kernels.nitro_matmul import ref as jmm_ref
from repro.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul_grad_x as j_nitro_matmul_grad_x,
)
from repro_torch.configs import paper as tpaper
from repro_torch.core import layers as tlayers
from repro_torch.core import model as tmodel
from repro_torch.core import optimizer as topt
from repro_torch.core import prng
from repro_torch.kernels.digit_planes import digits_needed, s8_digits
from repro_torch.kernels.nitro_conv import ref as tconv_ref
from repro_torch.kernels.nitro_matmul import ref as tmm_ref

I32 = (-(2 ** 31), 2 ** 31)
#: bounds of values that need one to four base-256 digits (the last with
#: INT32_MIN/MAX planted)
LIMS = {1: 100, 2: 20000, 3: 2 ** 20, 4: 2 ** 31 - 1}
#: conv shapes (N, H, W, C, F, K): F = 20 (the masked patch planes) with
#: C = 3 and an odd batch, F = 32 (the NHWC planes) with C = 5
CONV_SHAPES = [(3, 5, 6, 3, 20, 3), (1, 4, 5, 5, 32, 3)]
#: linear shapes (B, M, N): an odd batch, and 65 samples (two batch tiles)
LINEAR_SHAPES = [(3, 70, 130), (65, 9, 200)]


def _eq(t, *js) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    for j in js:
        j = np.asarray(j)
        assert got.dtype == j.dtype, (got.dtype, j.dtype)
        assert got.shape == j.shape, (got.shape, j.shape)
        np.testing.assert_array_equal(got, j)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _lim(rng, shape, nd):
    """Values within ±LIMS[nd], the largest planted first (INT32_MIN/MAX
    at four digits), so that they need exactly ``nd`` digits."""
    lim = LIMS[nd]
    a = rng.integers(-lim, lim, shape, dtype=np.int64).astype(np.int32)
    flat = a.reshape(-1)
    if nd == 4:
        flat[:2] = [I32[0], I32[1] - 1][:flat.size]
    else:
        flat[0] = lim - 1
    return a


def _operands(rng, kind, shape, nd, nw):
    """(δ, z*, w) of one case: the masked δ needs ``nd`` digits, w ``nw``;
    z* over every NITRO-ReLU segment but 0 where the extremes sit, so the
    mask keeps them."""
    if kind == "conv":
        n, h, w_sp, c, f, k = shape
        d_shape, w_shape = (n, h, w_sp, f), (k, k, c, f)
    else:
        b, m, n = shape
        d_shape, w_shape = (b, n), (m, n)
    z = rng.integers(-300, 301, d_shape).astype(np.int32)
    z.reshape(-1)[:2] = 0
    return _lim(rng, d_shape, nd), z, _lim(rng, w_shape, nw)


def _jax_grad_x(kind, delta, z, w, alpha_inv, interpret=True):
    """JAX's reference and, with ``interpret``, its Pallas kernel in
    interpret mode."""
    jd, jz, jw = jnp.asarray(delta), jnp.asarray(z), jnp.asarray(w)
    if kind == "conv":
        out = [jconv_ref.stream_conv_grad_x_ref(jd, jw, z_star=jz, alpha_inv=alpha_inv)]
        if interpret:
            out.append(jconv_kernels.stream_conv_grad_x(jd, jz, jw, alpha_inv=alpha_inv,
                                                        interpret=True))
        return out
    out = [jmm_ref.nitro_matmul_grad_x_ref(jd, jz, jw, alpha_inv=alpha_inv)]
    if interpret:
        out.append(j_nitro_matmul_grad_x(jd, jz, jw, alpha_inv=alpha_inv, interpret=True,
                                         bm=32, bn=32, bk=32))
    return out


def _digits_model(kind, delta, z, w, alpha_inv):
    if kind == "conv":
        return tconv_ref.stream_conv_grad_x_digits(_t(delta), _t(w), z_star=_t(z),
                                                   alpha_inv=alpha_inv)
    return tmm_ref.nitro_matmul_grad_x_digits(_t(delta), _t(z), _t(w), alpha_inv=alpha_inv)


VARIANTS = [(kind, shape, nd, nw)
            for kind, shapes in (("conv", CONV_SHAPES), ("linear", LINEAR_SHAPES))
            for shape in shapes for nd in LIMS for nw in LIMS]


@pytest.mark.parametrize("kind,shape,nd,nw", VARIANTS,
                         ids=[f"{k}-{'x'.join(map(str, s))}-d{nd}-w{nw}"
                              for k, s, nd, nw in VARIANTS])
def test_grad_x_digit_variants_match_jax(kind, shape, nd, nw):
    """Every (masked δ digits, w digits) variant of both kernels' models,
    at α_inv 10, ≡ JAX's reference and Pallas kernel; the operands need
    exactly the digits the variant names."""
    rng = np.random.default_rng(100 * nd + 10 * nw + len(shape))
    delta, z, w = _operands(rng, kind, shape, nd, nw)
    masked = tmm_ref.masked_delta(_t(delta), _t(z), 10)
    assert (digits_needed(masked), digits_needed(_t(w))) == (nd, nw)
    _eq(_digits_model(kind, delta, z, w, 10), *_jax_grad_x(kind, delta, z, w, 10))


ALPHA_CASES = [("conv", s) for s in [*CONV_SHAPES, (2, 6, 5, 3, 33, 5), (1, 3, 4, 16, 70, 3)]]
ALPHA_CASES += [("linear", s) for s in [*LINEAR_SHAPES, (1, 1, 1), (7, 13, 5)]]


@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
@pytest.mark.parametrize("kind,shape", ALPHA_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s in ALPHA_CASES])
def test_grad_x_digits_full_range_match_jax(kind, shape, alpha_inv):
    """Full-range int32 δ and w (the sums wrap mod 2³²) at α_inv 1, 2 and
    10: K = 5 with F = 33 and F = 70 (the patch planes), C = 3 and 16,
    batches of 1, 3, 7 and 65."""
    rng = np.random.default_rng(alpha_inv + len(shape) + shape[-1])
    delta, z, w = _operands(rng, kind, shape, 4, 4)
    _eq(_digits_model(kind, delta, z, w, alpha_inv), *_jax_grad_x(kind, delta, z, w, alpha_inv))


@pytest.mark.parametrize("b,m,n,slots", [
    (3, 5, 17000, 132),   # deeper than 16,384: at least two splits
    (1, 10, 20000, 132),  # one tile, many splits
    (2, 70, 40000, 4),    # two tiles on four slots: a wave per split
    (5, 7, 300, 1),       # one slot: one split
])
def test_grad_x_matmul_split_plans_match_jax(b, m, n, slots):
    """#5's split plan (the C++ planner's mirror) and the last-arrival sum
    of its splits: every split at most 16,384 deep, more splits than tiles
    where a tile's contraction is deep, and the sum ≡ JAX's."""
    rng = np.random.default_rng(n + slots)
    delta, z, w = _operands(rng, "linear", (b, m, n), 4, 4)
    tiles = -(-m // tmm_ref.MATMUL_TILE) * -(-b // tmm_ref.MATMUL_TILE)
    np_ = -(-n // tmm_ref.STAGE) * tmm_ref.STAGE
    splits, chunk = tmm_ref.plan_splits(tiles, np_, slots)
    assert chunk <= tmm_ref.MAX_SPLIT and splits * chunk >= np_
    if n > tmm_ref.MAX_SPLIT:
        assert splits >= 2
    if (b, m, n) == (1, 10, 20000):
        assert splits > tiles
    got = tmm_ref.nitro_matmul_grad_x_digits(_t(delta), _t(z), _t(w), alpha_inv=3,
                                             slots=slots)
    _eq(got, *_jax_grad_x("linear", delta, z, w, 3, interpret=n < 30000))


@pytest.mark.parametrize("k,c,f", [(3, 3, 20), (3, 5, 32), (5, 6, 33), (1, 4, 7)])
def test_rot_w_digit_planes_are_the_rotated_weights(k, c, f):
    """The rotated-weight pre-pass reads w as it lies and writes the digit
    planes of JAX's rot180_swap(w) flattened to (K²F, C), transposed."""
    w = _lim(np.random.default_rng(k * c * f), (k, k, c, f), 4)
    planes, need = tconv_ref.rot_w_digit_planes(_t(w))
    rot = np.asarray(jconv_ref.rot180_swap(jnp.asarray(w))).reshape(k * k * f, c)
    want = s8_digits(_t(rot).T.contiguous())
    mp = -(-k * k * f // 64) * 64
    assert planes.shape == (4, c, mp) and need == 4
    assert torch.equal(planes[:, :, :k * k * f], want)
    assert not planes[:, :, k * k * f:].any()


def test_grad_x_w_planes_count_per_warp_step():
    """w's digit count is per 16 rows × 32-deep step: one such block of
    four-digit values among one-digit ones gets 4, every other 1, and
    the products the counts skip are zero."""
    w = np.random.default_rng(3).integers(-100, 100, (40, 100)).astype(np.int32)
    w[17, 70] = I32[0]  # rows 16–31, columns 64–95
    planes, need = tmm_ref.grad_x_w_planes(_t(w))
    assert planes.shape == (4, 40, 128) and need.shape == (40, 128)
    block = torch.zeros_like(need, dtype=torch.bool)
    block[16:32, 64:96] = True
    assert bool((need[block] == 4).all()) and bool((need[~block] == 1).all())
    for j in range(4):
        assert not planes[j][need <= j].any()


@pytest.mark.parametrize("arch,scale,batch", [("vgg8b", 0.0625, 3), ("mlp4", 0.0625, 5)])
def test_grad_x_pass_matches_jax(arch, scale, batch):
    """A grad_x pass over every block, as the card's grad_x phase runs it:
    the port's train-mode forward of a seeded init and batch gives each
    block's caches (x and z*; the forward ≡ JAX's is held elsewhere), δ at
    each forward layer's output comes from a seed, then
    ``layers.*_backward`` and ``*_update`` with z* on both sides — grad_x,
    grad_W and W′ ≡ JAX's — and grad_x ≡ the digit model of its kernel."""
    cfg = tpaper.get(arch, scale=scale)
    params = tmodel.init_params(prng.PRNGKey(4), cfg, device="cpu")
    x = np.random.default_rng(4).integers(-127, 128, (batch, *cfg.input_shape))
    _, _, caches, _ = tmodel.forward(params, cfg, _t(x.astype(np.int32)), train=True,
                                     key=prng.PRNGKey(4))
    rng = np.random.default_rng(5)
    for spec, p, cache in zip(cfg.blocks, params["blocks"], caches):
        z, w = cache["z_star"].numpy(), p["fw"]["w"].numpy()
        delta = rng.integers(-(2 ** 20), 2 ** 20, z.shape).astype(np.int32)
        kw = dict(z_star=_t(z), alpha_inv=spec.alpha_inv)
        jkw = dict(z_star=jnp.asarray(z), alpha_inv=spec.alpha_inv, backend="reference")
        tw, jw = {"w": _t(w)}, {"w": jnp.asarray(w)}
        if spec.kind == "conv":
            xin = cache["conv"].x
            tcache, jcache = tlayers.ConvCache(x=xin), jlayers.ConvCache(x=jnp.asarray(xin))
            tb, jb, tu, ju = (tlayers.conv_backward, jlayers.conv_backward,
                              tlayers.conv_update, jlayers.conv_update)
        else:
            tcache, jcache = cache["linear"], jnp.asarray(cache["linear"])
            tb, jb, tu, ju = (tlayers.linear_backward, jlayers.linear_backward,
                              tlayers.linear_update, jlayers.linear_update)
        gx, gw = tb(tw, tcache, _t(delta), **kw)
        jgx, jgw = jb(jw, jcache, jnp.asarray(delta), **jkw)
        ux, new = tu(tw, tcache, _t(delta), topt.init_state(512, 3000), **kw)
        jux, jnew = ju(jw, jcache, jnp.asarray(delta), jopt.init_state(512, 3000), **jkw)
        _eq(gx, jgx)
        _eq(ux, jux, jgx)
        _eq(gw["w"], jgw["w"])
        _eq(new["w"], jnew["w"])
        _eq(_digits_model(spec.kind, delta, z, w, spec.alpha_inv), jgx)
