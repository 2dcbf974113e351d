"""PyTorch port, grad_x slice: the input gradient ≡ the JAX package's,
bitwise, on the CPU.

Covers the plain versions of the two input-gradient kernels
(``nitro_matmul_grad_x``, ``stream_conv_grad_x``) against the JAX oracles
and the Pallas kernels in interpret mode; ``grad_ops`` and the ``layers``
backward/update functions returning ``(grad_x, …)`` across ``z_star`` set
or ``None`` × ``fuse_bwd`` × ``conv_mode`` × α_inv; the materialised
training route; and the LES step, which must still compute no grad_x.
The same numpy inputs go through both sides; tolerance zero, dtype
included.  The CUDA kernels themselves run only on a card:
``tests/test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import layers as jlayers
from repro.core import les as jles
from repro.core import optimizer as jopt
from repro.kernels import grad_ops as jgrad_ops
from repro.kernels.nitro_conv import nitro_conv as jconv_kernels
from repro.kernels.nitro_conv import ops as jconv_ops
from repro.kernels.nitro_conv import ref as jconv_ref
from repro.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul_grad_x as j_nitro_matmul_grad_x,
)
from repro.kernels.nitro_matmul import ref as jmm_ref
from repro_torch.configs import paper as tpaper
from repro_torch.core import layers as tlayers
from repro_torch.core import les as tles
from repro_torch.core import optimizer as topt
from repro_torch.core import prng
from repro_torch.kernels import grad_ops as tgrad_ops
from repro_torch.kernels.nitro_conv import nitro_conv as tconv_kernels
from repro_torch.kernels.nitro_conv import ops as tconv_ops
from repro_torch.kernels.nitro_conv import ref as tconv_ref
from repro_torch.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul_grad_x as t_nitro_matmul_grad_x,
)
from repro_torch.kernels.nitro_matmul import ops as tmm_ops
from repro_torch.kernels.nitro_matmul import ref as tmm_ref

I32 = (-(2 ** 31), 2 ** 31)


def _eq(t, *js) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    for j in js:
        j = np.asarray(j)
        assert got.dtype == j.dtype, (got.dtype, j.dtype)
        assert got.shape == j.shape, (got.shape, j.shape)
        np.testing.assert_array_equal(got, j)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ints(rng, shape, lo, hi):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


def _grad_operands(rng, shape, wide=False):
    """δ of both signs (full-range int32 when ``wide``: the products wrap)
    and a z* that hits every NITRO-ReLU segment."""
    delta = _ints(rng, shape, *I32) if wide else _ints(rng, shape, -(2 ** 12), 2 ** 12)
    return delta, _ints(rng, shape, -300, 301)


def _linear_case(b, m, n, seed, wide=False):
    rng = np.random.default_rng(seed)
    delta, z = _grad_operands(rng, (b, n), wide)
    w = _ints(rng, (m, n), *I32) if wide else _ints(rng, (m, n), -(2 ** 10), 2 ** 10)
    x = _ints(rng, (b, m), -127, 128)
    return x, delta, z, w


def _conv_case(n, h, w_sp, c, f, k, seed, wide=False):
    rng = np.random.default_rng(seed)
    delta, z = _grad_operands(rng, (n, h, w_sp, f), wide)
    w = (_ints(rng, (k, k, c, f), *I32) if wide
         else _ints(rng, (k, k, c, f), -(2 ** 10), 2 ** 10))
    x = _ints(rng, (n, h, w_sp, c), -127, 128)
    return x, delta, z, w


# ---------------------------------------------------------------------------
# Kernel 5: nitro_matmul_grad_x — plain version ≡ JAX oracle ≡ Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,m,n,wide", [
    (1, 1, 1, False), (7, 13, 5, False), (33, 70, 65, False), (64, 40, 130, False),
    (9, 20, 30, True),
])
@pytest.mark.parametrize("alpha_inv", [1, 10])
def test_nitro_matmul_grad_x_ref_matches_jax(b, m, n, wide, alpha_inv):
    """relu_bwd(z*, δ) @ wᵀ with w (M, N) in its natural layout: ragged
    shapes, α_inv 1 and 10, full-range int32 (the sum wraps mod 2³²)."""
    _, delta, z, w = _linear_case(b, m, n, seed=b + m + n + alpha_inv, wide=wide)
    got = tmm_ref.nitro_matmul_grad_x_ref(_t(delta), _t(z), _t(w), alpha_inv=alpha_inv)
    jd, jz, jw = jnp.asarray(delta), jnp.asarray(z), jnp.asarray(w)
    _eq(got,
        jmm_ref.nitro_matmul_grad_x_ref(jd, jz, jw, alpha_inv=alpha_inv),
        j_nitro_matmul_grad_x(jd, jz, jw, alpha_inv=alpha_inv, interpret=True,
                              bm=32, bn=32, bk=32))
    disp = tmm_ops.grad_x_matmul(_t(delta), _t(z), _t(w), alpha_inv=alpha_inv)
    assert torch.equal(disp, got)


# ---------------------------------------------------------------------------
# Kernel 10: stream_conv_grad_x — band oracle ≡ JAX oracle ≡ Pallas
# ---------------------------------------------------------------------------


def test_rot180_swap_matches_jax():
    w = np.arange(3 * 3 * 2 * 4, dtype=np.int32).reshape(3, 3, 2, 4)
    _eq(tconv_ref.rot180_swap(_t(w)), jconv_ref.rot180_swap(jnp.asarray(w)))


@pytest.mark.parametrize("n,h,w_sp,c,f,k,bh,wide", [
    (2, 6, 5, 3, 4, 3, None, False),
    (1, 7, 6, 3, 12, 3, 2, False),
    (2, 5, 7, 4, 6, 5, 3, False),
    (3, 4, 4, 5, 3, 3, 8, True),
])
@pytest.mark.parametrize("alpha_inv", [1, 10])
def test_stream_conv_grad_x_ref_matches_jax(n, h, w_sp, c, f, k, bh, wide, alpha_inv):
    """The 'full' correlation of the band-masked δ with rot180_swap(w):
    C = 3, K = 5, band heights that do not divide H, full-range int32."""
    _, delta, z, w = _conv_case(n, h, w_sp, c, f, k, seed=h * 7 + f + alpha_inv, wide=wide)
    got = tconv_ref.stream_conv_grad_x_ref(_t(delta), _t(w), z_star=_t(z),
                                           alpha_inv=alpha_inv, bh=bh)
    jd, jz, jw = jnp.asarray(delta), jnp.asarray(z), jnp.asarray(w)
    _eq(got,
        jconv_ref.stream_conv_grad_x_ref(jd, jw, z_star=jz, alpha_inv=alpha_inv),
        jconv_kernels.stream_conv_grad_x(jd, jz, jw, alpha_inv=alpha_inv, interpret=True))
    # without z*: the unmasked conv (what stream_conv at sf=1 computes)
    _eq(tconv_ref.stream_conv_grad_x_ref(_t(delta), _t(w), bh=bh),
        jconv_ref.stream_conv_grad_x_ref(jd, jw))


def test_band_mask_equals_premask():
    """Masking each band equals masking δ first: the zero halo stays zero."""
    _, delta, z, w = _conv_case(2, 6, 5, 3, 4, 3, seed=9)
    pre = tmm_ref.masked_delta(_t(delta), _t(z), 3)
    assert torch.equal(
        tconv_ref.stream_conv_grad_x_ref(_t(delta), _t(w), z_star=_t(z), alpha_inv=3),
        tconv_ref.stream_conv_grad_x_ref(pre, _t(w)))


# ---------------------------------------------------------------------------
# Dispatchers: every conv_mode, and the materialised training route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("conv_mode", ["stream", "materialise"])
@pytest.mark.parametrize("with_z", [True, False])
def test_conv_grad_x_dispatch_matches_jax(conv_mode, with_z):
    _, delta, z, w = _conv_case(2, 6, 7, 3, 5, 3, seed=11)
    tz, jz = (_t(z), jnp.asarray(z)) if with_z else (None, None)
    got = tconv_ops.conv_grad_x(_t(delta), _t(w), z_star=tz, alpha_inv=2,
                                conv_mode=conv_mode)
    _eq(got, jconv_ops.conv_grad_x(jnp.asarray(delta), jnp.asarray(w), z_star=jz,
                                   alpha_inv=2, backend="reference", conv_mode=conv_mode))


@pytest.mark.parametrize("with_z", [True, False])
def test_materialise_training_route_matches_jax(with_z):
    """fused_conv_fwd and conv_grad_w with conv_mode='materialise' — the
    explicit-im2col route — ≡ JAX's, and ≡ the streamed route."""
    x, delta, z, w = _conv_case(2, 6, 5, 4, 7, 3, seed=12)
    w = w // 64
    kw = dict(sf=256 * 36, alpha_inv=3)
    a, zs = tconv_ops.fused_conv_fwd(_t(x), _t(w), conv_mode="materialise", **kw)
    ja, jzs = jconv_ops.fused_conv_fwd(jnp.asarray(x), jnp.asarray(w),
                                       conv_mode="materialise", backend="reference", **kw)
    _eq(a, ja)
    _eq(zs, jzs)
    sa, szs = tconv_ops.fused_conv_fwd(_t(x), _t(w), **kw)
    assert torch.equal(sa, a) and torch.equal(szs, zs)
    tz, jz = (_t(z), jnp.asarray(z)) if with_z else (None, None)
    gw = tconv_ops.conv_grad_w(_t(x), _t(delta), kernel_size=3, z_star=tz, alpha_inv=3,
                               conv_mode="materialise")
    _eq(gw, jconv_ops.conv_grad_w(jnp.asarray(x), jnp.asarray(delta), kernel_size=3,
                                  z_star=jz, alpha_inv=3, backend="reference",
                                  conv_mode="materialise"))
    assert torch.equal(gw, tconv_ops.conv_grad_w(_t(x), _t(delta), kernel_size=3,
                                                 z_star=tz, alpha_inv=3))


# ---------------------------------------------------------------------------
# grad_ops and layers: (grad_x, …) in every combination
# ---------------------------------------------------------------------------

Z_FUSE = [(True, True), (True, False), (False, True), (False, False)]
Z_IDS = ["z-fused", "z-unfused", "no_z-fused", "no_z-unfused"]


@pytest.mark.parametrize("alpha_inv", [1, 10])
@pytest.mark.parametrize("with_z,fuse_bwd", Z_FUSE, ids=Z_IDS)
@pytest.mark.parametrize("fn", ["linear_grads", "linear_weight_update"])
def test_grad_ops_linear_matches_jax(fn, with_z, fuse_bwd, alpha_inv):
    x, delta, z, w = _linear_case(6, 20, 9, seed=alpha_inv + 2 * with_z)
    tz, jz = (_t(z), jnp.asarray(z)) if with_z else (None, None)
    kw = dict(z_star=tz, alpha_inv=alpha_inv, fuse_bwd=fuse_bwd)
    jkw = dict(z_star=jz, alpha_inv=alpha_inv, fuse_bwd=fuse_bwd, backend="reference")
    targs = [_t(a) for a in (x, w, delta)]
    jargs = [jnp.asarray(a) for a in (x, w, delta)]
    if fn == "linear_weight_update":
        targs.append(topt.init_state(512, 12000))
        jargs.append(jopt.init_state(512, 12000))
    gx, out = getattr(tgrad_ops, fn)(*targs, **kw)
    jgx, jout = getattr(jgrad_ops, fn)(*jargs, **jkw)
    assert gx is not None
    _eq(gx, jgx)
    _eq(out, jout)
    skipped, same = getattr(tgrad_ops, fn)(*targs, **kw, need_grad_x=False)
    assert skipped is None and torch.equal(same, out)


@pytest.mark.parametrize("alpha_inv", [1, 10])
@pytest.mark.parametrize("conv_mode", ["stream", "materialise"])
@pytest.mark.parametrize("with_z,fuse_bwd", Z_FUSE, ids=Z_IDS)
@pytest.mark.parametrize("fn", ["conv_grads", "conv_weight_update"])
def test_grad_ops_conv_matches_jax(fn, with_z, fuse_bwd, conv_mode, alpha_inv):
    x, delta, z, w = _conv_case(2, 6, 5, 3, 7, 3, seed=alpha_inv + 3 * with_z)
    tz, jz = (_t(z), jnp.asarray(z)) if with_z else (None, None)
    kw = dict(z_star=tz, alpha_inv=alpha_inv, fuse_bwd=fuse_bwd, conv_mode=conv_mode)
    jkw = dict(z_star=jz, alpha_inv=alpha_inv, fuse_bwd=fuse_bwd, conv_mode=conv_mode,
               backend="reference")
    targs = [_t(a) for a in (x, w, delta)]
    jargs = [jnp.asarray(a) for a in (x, w, delta)]
    if fn == "conv_weight_update":
        targs.append(topt.init_state(3, 7))
        jargs.append(jopt.init_state(3, 7))
    gx, out = getattr(tgrad_ops, fn)(*targs, **kw)
    jgx, jout = getattr(jgrad_ops, fn)(*jargs, **jkw)
    assert gx is not None
    _eq(gx, jgx)
    _eq(out, jout)
    skipped, same = getattr(tgrad_ops, fn)(*targs, **kw, need_grad_x=False)
    assert skipped is None and torch.equal(same, out)


@pytest.mark.parametrize("alpha_inv", [1, 10])
@pytest.mark.parametrize("with_z,fuse_bwd", Z_FUSE, ids=Z_IDS)
@pytest.mark.parametrize("update", [False, True], ids=["backward", "update"])
def test_layers_linear_match_jax(update, with_z, fuse_bwd, alpha_inv):
    x, delta, z, w = _linear_case(5, 16, 11, seed=7 + alpha_inv)
    tz, jz = (_t(z), jnp.asarray(z)) if with_z else (None, None)
    kw = dict(z_star=tz, alpha_inv=alpha_inv, fuse_bwd=fuse_bwd)
    jkw = dict(z_star=jz, alpha_inv=alpha_inv, fuse_bwd=fuse_bwd, backend="reference")
    if update:
        gx, new = tlayers.linear_update({"w": _t(w)}, _t(x), _t(delta),
                                        topt.init_state(512, 3000), **kw)
        jgx, jnew = jlayers.linear_update({"w": jnp.asarray(w)}, jnp.asarray(x),
                                          jnp.asarray(delta), jopt.init_state(512, 3000),
                                          **jkw)
    else:
        gx, new = tlayers.linear_backward({"w": _t(w)}, _t(x), _t(delta), **kw)
        jgx, jnew = jlayers.linear_backward({"w": jnp.asarray(w)}, jnp.asarray(x),
                                            jnp.asarray(delta), **jkw)
    _eq(gx, jgx)
    _eq(new["w"], jnew["w"])


@pytest.mark.parametrize("alpha_inv", [1, 10])
@pytest.mark.parametrize("conv_mode", ["stream", "materialise"])
@pytest.mark.parametrize("with_z,fuse_bwd", Z_FUSE, ids=Z_IDS)
@pytest.mark.parametrize("update", [False, True], ids=["backward", "update"])
def test_layers_conv_match_jax(update, with_z, fuse_bwd, conv_mode, alpha_inv):
    x, delta, z, w = _conv_case(2, 5, 6, 4, 6, 3, seed=13 + alpha_inv)
    tz, jz = (_t(z), jnp.asarray(z)) if with_z else (None, None)
    kw = dict(z_star=tz, alpha_inv=alpha_inv, fuse_bwd=fuse_bwd, conv_mode=conv_mode)
    jkw = dict(z_star=jz, alpha_inv=alpha_inv, fuse_bwd=fuse_bwd, conv_mode=conv_mode,
               backend="reference")
    tcache, jcache = tlayers.ConvCache(x=_t(x)), jlayers.ConvCache(x=jnp.asarray(x))
    if update:
        gx, new = tlayers.conv_update({"w": _t(w)}, tcache, _t(delta),
                                      topt.init_state(3, 7), **kw)
        jgx, jnew = jlayers.conv_update({"w": jnp.asarray(w)}, jcache, jnp.asarray(delta),
                                        jopt.init_state(3, 7), **jkw)
    else:
        gx, new = tlayers.conv_backward({"w": _t(w)}, tcache, _t(delta), **kw)
        jgx, jnew = jlayers.conv_backward({"w": jnp.asarray(w)}, jcache,
                                          jnp.asarray(delta), **jkw)
    _eq(gx, jgx)
    _eq(new["w"], jnew["w"])


# ---------------------------------------------------------------------------
# The LES step computes no grad_x; the materialised step trains
# ---------------------------------------------------------------------------

SCALE = 0.0625
BATCH = 4


def _batch(cfg, it, seed=0):
    rng = np.random.default_rng(seed * 100 + it)
    x = rng.integers(-127, 128, (BATCH, *cfg.input_shape)).astype(np.int32)
    y = rng.integers(0, cfg.num_classes, BATCH).astype(np.int32)
    return x, y


def _param_leaves(params) -> list:
    return ([b[k]["w"] for b in params["blocks"] for k in ("fw", "lr")]
            + [params["output"]["w"]])


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls[name] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("path", ["split", "fuse_opt", "fused_apply"])
def test_les_step_computes_no_grad_x(monkeypatch, path):
    """The LES step reaches neither grad_x dispatcher (so no #5/#10 launch
    on the card) while its grad_W dispatch count per VGG8B step stays 6/1;
    its state still equals the JAX step's."""
    calls = {n: 0 for n in ("grad_x_matmul", "conv_grad_x", "grad_w_matmul",
                            "conv_grad_w", "grad_w_opt_matmul", "conv_grad_w_opt")}
    for n in ("grad_x_matmul", "grad_w_matmul", "grad_w_opt_matmul"):
        _spy(monkeypatch, tmm_ops, n, calls)
    for n in ("conv_grad_x", "conv_grad_w", "conv_grad_w_opt"):
        _spy(monkeypatch, tconv_ops, n, calls)
    tcfg, jcfg = tpaper.get("vgg8b", scale=SCALE), jpaper.get("vgg8b", scale=SCALE)
    ts = tles.create_train_state(prng.PRNGKey(0), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(0), jcfg)
    x, y = _batch(tcfg, 0)
    if path == "fused_apply":
        grads, _, _ = tles.compute_gradients(ts, tcfg, _t(x), _t(y), prng.PRNGKey(0))
        ts = tles.apply_gradients(ts, grads, fuse_opt=True)
    else:
        ts, _ = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(0),
                                fuse_opt=path == "fuse_opt")
    js, _ = jax.jit(functools.partial(jles.train_step, cfg=jcfg, backend="reference"))(
        js, x=jnp.asarray(x), labels=jnp.asarray(y), key=jax.random.PRNGKey(0))
    want = ({"grad_w_opt_matmul": 1, "conv_grad_w_opt": 6} if path == "fuse_opt"
            else {"grad_w_matmul": 1, "conv_grad_w": 6})
    assert calls == {n: want.get(n, 0) for n in calls}
    for a, b in zip(_param_leaves(ts.params), _param_leaves(js.params), strict=True):
        _eq(a, b)


@pytest.mark.parametrize("fuse_opt", [False, True])
def test_materialise_step_matches_jax(fuse_opt):
    """Two VGG8B steps with conv_mode='materialise' ≡ the JAX step."""
    tcfg, jcfg = tpaper.get("vgg8b", scale=SCALE), jpaper.get("vgg8b", scale=SCALE)
    ts = tles.create_train_state(prng.PRNGKey(1), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(1), jcfg)
    jstep = jax.jit(functools.partial(jles.train_step, cfg=jcfg, backend="reference",
                                      conv_mode="materialise", fuse_opt=fuse_opt))
    for it in range(2):
        x, y = _batch(tcfg, it, seed=1)
        ts, tm = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(it),
                                 conv_mode="materialise", fuse_opt=fuse_opt)
        js, jm = jstep(js, x=jnp.asarray(x), labels=jnp.asarray(y),
                       key=jax.random.PRNGKey(it))
        _eq(tm.loss, jm.loss)
        _eq(tm.local_losses, jm.local_losses)
    for a, b in zip(_param_leaves(ts.params), _param_leaves(js.params), strict=True):
        _eq(a, b)


def test_grad_x_kernels_no_cpu_fallback():
    """CPU tensors never reach a grad_x kernel: the wrappers and
    backend='cuda' raise, and no launch is counted."""
    _, delta, z, w = (_t(a) for a in _linear_case(4, 6, 5, seed=9))
    _, cd, cz, cw = (_t(a) for a in _conv_case(2, 4, 4, 3, 5, 3, seed=9))
    on_card = "on one CUDA device"
    with pytest.raises(ValueError, match=on_card):
        t_nitro_matmul_grad_x(delta, z, w)
    with pytest.raises(ValueError, match=on_card):
        tconv_kernels.stream_conv_grad_x(cd, cz, cw)
    cuda_only = "backend='cuda' needs CUDA tensors"
    with pytest.raises(ValueError, match=cuda_only):
        tmm_ops.grad_x_matmul(delta, z, w, backend="cuda")
    with pytest.raises(ValueError, match=cuda_only):
        tconv_ops.conv_grad_x(cd, cw, z_star=cz, backend="cuda")
    with pytest.raises(ValueError, match="alpha_inv"):
        tmm_ops.grad_x_matmul(delta, z, w, alpha_inv=0)
    assert t_nitro_matmul_grad_x.launches.value == 0
    assert tconv_kernels.stream_conv_grad_x.launches.value == 0
