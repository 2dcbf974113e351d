"""PyTorch port, kernels: each plain version ≡ the JAX Pallas kernel (run in
interpret mode, as the JAX suite runs it on the CPU) ≡ the JAX oracle.

Tolerance zero, dtype included: every value is an integer.  The CUDA
kernels themselves run only on a card: ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.nitro_conv import ops as jconv_ops
from repro.kernels.nitro_conv import ref as jconv_ref
from repro.kernels import grad_ops as jgrad_ops
from repro.kernels.nitro_conv.nitro_conv import stream_conv as j_stream_conv
from repro.kernels.nitro_conv.nitro_conv import stream_conv_fwd as j_stream_conv_fwd
from repro.kernels.nitro_conv.nitro_conv import stream_conv_grad_w as j_stream_conv_grad_w
from repro.kernels.nitro_matmul import ops as jmm_ops
from repro.kernels.nitro_matmul import ref as jmm_ref
from repro.kernels.nitro_matmul.nitro_matmul import nitro_matmul as j_nitro_matmul
from repro.kernels.nitro_matmul.nitro_matmul import nitro_matmul_fwd as j_nitro_matmul_fwd
from repro.kernels.nitro_matmul.nitro_matmul import nitro_matmul_grad_w as j_nitro_matmul_grad_w
from repro.kernels.nitro_matmul.ref import nitro_matmul_ref as j_nitro_matmul_ref
from repro_torch.kernels import grad_ops as tgrad_ops
from repro_torch.kernels.nitro_conv import ops as tconv_ops
from repro_torch.kernels.nitro_conv import ref as tconv_ref
from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv as t_stream_conv
from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv_fwd as t_stream_conv_fwd
from repro_torch.kernels.nitro_conv.nitro_conv import (
    stream_conv_grad_w as t_stream_conv_grad_w,
)
from repro_torch.kernels.nitro_matmul import ops as tmm_ops
from repro_torch.kernels.nitro_matmul import ref as tmm_ref
from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul as t_nitro_matmul
from repro_torch.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul_fwd as t_nitro_matmul_fwd,
)
from repro_torch.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul_grad_w as t_nitro_matmul_grad_w,
)
from repro_torch.kernels.nitro_matmul.ref import nitro_matmul_ref as t_nitro_matmul_ref

_T = {"int8": torch.int8, "int32": torch.int32}
_J = {"int8": jnp.int8, "int32": jnp.int32}


def _eq(t: torch.Tensor, *js) -> None:
    got = t.numpy()
    for j in js:
        j = np.asarray(j)
        assert got.dtype == j.dtype, (got.dtype, j.dtype)
        np.testing.assert_array_equal(got, j)


def _operands(rng, shapes, operands: str):
    """int8 operands in [-127, 127]; int32 operands over the full range
    (products wrap mod 2³² — the JAX kernel's int32 dot wraps too)."""
    if operands == "int8":
        return [rng.integers(-127, 128, s).astype(np.int8) for s in shapes]
    return [rng.integers(-(2 ** 31), 2 ** 31 - 1, s, dtype=np.int64).astype(np.int32)
            for s in shapes]


# ---------------------------------------------------------------------------
# Kernel 1: nitro_matmul
# ---------------------------------------------------------------------------

# odd residual SFs sized so z* spans every NITRO-ReLU segment for int8 data
_MM_SHAPES = [((5, 7, 3), 3 << 5), ((64, 300, 70), 3 << 8), ((33, 2048, 10), 3 << 9)]


@pytest.mark.parametrize("shape,sf", _MM_SHAPES)
@pytest.mark.parametrize("operands", ["int8", "int32"])
@pytest.mark.parametrize("relu,out", [(True, "int8"), (True, "int32"), (False, "int32")])
def test_matmul_plain_matches_pallas(shape, sf, operands, relu, out):
    m, k, n = shape
    rng = np.random.default_rng(m * k + n)
    x, w = _operands(rng, [(m, k), (k, n)], operands)
    kw = dict(sf=sf, alpha_inv=10, apply_relu=relu)
    got = t_nitro_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                             out_dtype=_T[out], operand_dtype=operands, **kw)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    _eq(got,
        j_nitro_matmul(jx, jw, out_dtype=_J[out], operand_dtype=operands,
                       interpret=True, **kw),
        j_nitro_matmul_ref(jx, jw, out_dtype=_J[out], operand_dtype=operands, **kw))


@pytest.mark.parametrize("alpha_inv", [1, 2])
def test_matmul_plain_alpha_edges(alpha_inv):
    rng = np.random.default_rng(alpha_inv)
    x, w = _operands(rng, [(17, 40), (40, 9)], "int8")
    kw = dict(sf=3 << 4, alpha_inv=alpha_inv, apply_relu=True)
    got = t_nitro_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                             out_dtype=torch.int32, **kw)
    _eq(got, j_nitro_matmul(jnp.asarray(x), jnp.asarray(w), out_dtype=jnp.int32,
                            interpret=True, **kw))


def test_matmul_int8_product_overflow_trap():
    """torch CPU int8 @ int8 returns int8 and wraps; the plain version lifts."""
    x = np.full((3, 300), 100, np.int8)
    w = np.full((300, 4), -100, np.int8)
    assert (torch.from_numpy(x) @ torch.from_numpy(w)).dtype == torch.int8
    got = t_nitro_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), sf=256,
                             apply_relu=False, operand_dtype="int8")
    _eq(got, j_nitro_matmul_ref(jnp.asarray(x), jnp.asarray(w), sf=256,
                                apply_relu=False, operand_dtype="int8"))
    assert int(got[0, 0]) == (-3_000_000) // 256


def test_matmul_dispatcher_errors_match_jax():
    for fn in (tmm_ops.check_alpha_inv, jmm_ops.check_alpha_inv):
        assert fn(0, False) == 1 and fn(7, True) == 7
        with pytest.raises(ValueError, match="alpha_inv must be a positive integer"):
            fn(0, True)
    fits = np.array([[-127, 0, 127]], np.int32)
    over = np.array([[-128, 0, 5]], np.int32)
    assert tmm_ops._guard_int8(torch.from_numpy(fits), "x").dtype == torch.int8
    assert jmm_ops._guard_int8(jnp.asarray(fits), "x").dtype == jnp.int8
    with pytest.raises(ValueError, match="do not fit int8"):
        tmm_ops._guard_int8(torch.from_numpy(over), "x")
    with pytest.raises(ValueError, match="do not fit int8"):
        jmm_ops._guard_int8(jnp.asarray(over), "x")
    with pytest.raises(ValueError, match="unknown operand_dtype"):
        tmm_ops.resolve_operand_dtype("int4", torch.zeros(1), torch.zeros(1))
    with pytest.raises(ValueError, match="unknown backend"):
        tmm_ops.resolve_backend("pallas", "cpu")
    assert tmm_ops.resolve_backend("auto", "cpu") == "reference"
    assert tmm_ops.resolve_backend("auto", "cuda") == "cuda"


def test_matmul_no_cpu_fallback():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA tensors"):
        tmm_ops.fused_matmul(x, w, sf=256, backend="cuda")
    with pytest.raises(ValueError, match="needs x and w on one CUDA device"):
        t_nitro_matmul(x, w, sf=256)


def test_fused_matmul_forced_int8_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (9, 33)).astype(np.int32)
    w = rng.integers(-127, 128, (33, 6)).astype(np.int16)
    kw = dict(sf=3 << 6, out_dtype=None, operand_dtype="int8")
    got = tmm_ops.fused_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               **{**kw, "out_dtype": torch.int8})
    _eq(got, jmm_ops.fused_matmul(jnp.asarray(x), jnp.asarray(w), backend="reference",
                                  **{**kw, "out_dtype": jnp.int8}))


# ---------------------------------------------------------------------------
# Kernel 2: stream_conv
# ---------------------------------------------------------------------------

_CONV_CASES = [  # (N, H, W, C, F, K, pool, operands, bh, sf)
    (2, 7, 9, 5, 12, 3, True, "int8", 2, 3 << 5),
    (2, 9, 7, 6, 10, 5, False, "int32", 4, 3 << 6),
    (1, 11, 13, 3, 16, 3, True, "int32", 8, 3 << 4),
    (3, 8, 8, 4, 8, 3, False, "int8", 3, 3 << 5),
    (2, 6, 5, 3, 7, 5, True, "int8", 1, 3 << 5),
]


@pytest.mark.parametrize("n,h,w_sp,c,f,k,pool,operands,bh,sf", _CONV_CASES)
@pytest.mark.parametrize("out", ["int8", "int32"])
def test_conv_plain_matches_pallas(n, h, w_sp, c, f, k, pool, operands, bh, sf, out):
    rng = np.random.default_rng(h * w_sp + c)
    x = rng.integers(-127, 128, (n, h, w_sp, c)).astype(_J[operands])
    w = rng.integers(-127, 128, (k, k, c, f)).astype(_J[operands])
    kw = dict(sf=sf, alpha_inv=10, apply_relu=True, pool=pool)
    got = tconv_ref.stream_conv_ref(torch.from_numpy(x), torch.from_numpy(w), bh=bh,
                                    out_dtype=_T[out], operand_dtype=operands, **kw)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    _eq(got,
        j_stream_conv(jx, jw, bh=bh, out_dtype=_J[out], operand_dtype=operands,
                      interpret=True, **kw),
        jconv_ref.stream_conv_ref(jx, jw, bh=bh, out_dtype=_J[out],
                                  operand_dtype=operands, **kw))


def test_conv_plain_no_relu_int32_input_int8_weight():
    """Step 1's dtypes: int32 images × int8 weights, lifted to int32."""
    rng = np.random.default_rng(11)
    x = rng.integers(-127, 128, (2, 9, 9, 3)).astype(np.int32)
    w = rng.integers(-9, 10, (3, 3, 3, 6)).astype(np.int8)
    kw = dict(sf=27 << 3, apply_relu=False, pool=False)
    _eq(tconv_ref.stream_conv_ref(torch.from_numpy(x), torch.from_numpy(w), **kw),
        j_stream_conv(jnp.asarray(x), jnp.asarray(w), interpret=True, **kw))


def test_conv_geometry_matches_jax():
    for h in (1, 2, 5, 7, 8, 16, 31, 32):
        for k in (1, 3, 5):
            for bh in (None, 1, 2, 3, 8, 16, 40):
                for pool in (False, True):
                    assert tconv_ref.conv_geometry(h, k, bh, pool=pool) == \
                        jconv_ref.conv_geometry(h, k, bh, pool=pool)
    for mod in (tconv_ref, jconv_ref):
        with pytest.raises(ValueError, match="odd kernel"):
            mod.conv_geometry(8, 4, None, pool=False)


@pytest.mark.parametrize("pool", [False, True])
def test_conv_materialise_equals_stream(pool):
    rng = np.random.default_rng(int(pool))
    x = torch.from_numpy(rng.integers(-127, 128, (2, 9, 7, 6)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 6, 11)).astype(np.int8))
    kw = dict(sf=3 << 5, pool=pool, out_dtype=torch.int8)
    stream = tconv_ops.fused_conv(x, w, conv_mode="stream", **kw)
    mat = tconv_ops.fused_conv(x, w, conv_mode="materialise", **kw)
    assert torch.equal(stream, mat) and stream.dtype == mat.dtype
    j = jconv_ops.fused_conv(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                             backend="reference", conv_mode="stream",
                             **{**kw, "out_dtype": jnp.int8})
    _eq(stream, j)
    with pytest.raises(ValueError, match="unknown conv_mode"):
        tconv_ops.fused_conv(x, w, sf=256, conv_mode="im2col")


def test_conv_no_cpu_fallback():
    x = torch.zeros((1, 4, 4, 2), dtype=torch.int8)
    w = torch.zeros((3, 3, 2, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA tensors"):
        tconv_ops.fused_conv(x, w, sf=256, backend="cuda")
    with pytest.raises(ValueError, match="needs x and w on one CUDA device"):
        t_stream_conv(x, w, sf=256)


# ---------------------------------------------------------------------------
# Training kernels: nitro_matmul_fwd (#2), nitro_matmul_grad_w (#3),
# stream_conv_fwd (#7), stream_conv_grad_w (#8) — plain ≡ Pallas interpret
# ---------------------------------------------------------------------------


def _train_fwd_operands(rng, x_shape, w_shape):
    """int32 activations and weights wide enough that z* = ⌊x@w/SF⌋ lands
    in every NITRO-ReLU segment at the SFs below."""
    x = rng.integers(-127, 128, x_shape).astype(np.int32)
    w = rng.integers(-(2 ** 10), 2 ** 10, w_shape).astype(np.int32)
    return x, w


def _train_grad_operands(rng, out_shape, wide: bool = False):
    """δ of both signs (negative floor cases) and a z* spanning saturated,
    leaky, identity and saturated segments."""
    lim = 2 ** 31 - 1 if wide else 2 ** 20
    delta = rng.integers(-lim, lim, out_shape, dtype=np.int64).astype(np.int32)
    z = rng.integers(-300, 301, out_shape).astype(np.int32)
    return delta, z


_MM_TRAIN = [((5, 7, 3), 3 << 8), ((33, 300, 70), 3 << 10), ((64, 130, 40), 3 << 9)]


@pytest.mark.parametrize("shape,sf", _MM_TRAIN)
@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
def test_matmul_fwd_plain_matches_pallas(shape, sf, alpha_inv):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n + alpha_inv)
    x, w = _train_fwd_operands(rng, (m, k), (k, n))
    a, z = tmm_ref.nitro_matmul_fwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                                        sf=sf, alpha_inv=alpha_inv)
    ja, jz = j_nitro_matmul_fwd(jnp.asarray(x), jnp.asarray(w), sf=sf,
                                alpha_inv=alpha_inv, interpret=True)
    ra, rz = jmm_ref.nitro_matmul_fwd_ref(jnp.asarray(x), jnp.asarray(w), sf=sf,
                                          alpha_inv=alpha_inv)
    _eq(a, ja, ra)
    _eq(z, jz, rz)
    if z.numel() >= 1000:  # the larger shapes hit both saturated segments
        assert int(z.min()) < -127 and int(z.max()) > 127
    da, dz = tmm_ops.fused_matmul_fwd(torch.from_numpy(x), torch.from_numpy(w), sf=sf,
                                      alpha_inv=alpha_inv)
    assert torch.equal(da, a) and torch.equal(dz, z)


@pytest.mark.parametrize("shape", [(5, 7, 3), (40, 33, 70), (130, 64, 20)])
@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
@pytest.mark.parametrize("wide", [False, True])
def test_matmul_grad_w_plain_matches_pallas(shape, alpha_inv, wide):
    b, m, n = shape
    rng = np.random.default_rng(b * m + n + alpha_inv + wide)
    x = rng.integers(-(2 ** 31), 2 ** 31 - 1, (b, m), dtype=np.int64).astype(np.int32) \
        if wide else rng.integers(-127, 128, (b, m)).astype(np.int32)
    delta, z = _train_grad_operands(rng, (b, n), wide)
    got = tmm_ref.nitro_matmul_grad_w_ref(torch.from_numpy(x), torch.from_numpy(delta),
                                          torch.from_numpy(z), alpha_inv=alpha_inv)
    jx, jd, jz = jnp.asarray(x), jnp.asarray(delta), jnp.asarray(z)
    _eq(got,
        j_nitro_matmul_grad_w(jx, jd, jz, alpha_inv=alpha_inv, interpret=True),
        jmm_ref.nitro_matmul_grad_w_ref(jx, jd, jz, alpha_inv=alpha_inv))
    disp = tmm_ops.grad_w_matmul(torch.from_numpy(x), torch.from_numpy(delta),
                                 torch.from_numpy(z), alpha_inv=alpha_inv)
    assert torch.equal(disp, got)


@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
def test_masked_delta_matches_jax(alpha_inv):
    rng = np.random.default_rng(alpha_inv)
    delta, z = _train_grad_operands(rng, (400,), wide=True)
    _eq(tmm_ref.masked_delta(torch.from_numpy(delta), torch.from_numpy(z), alpha_inv),
        jmm_ref.masked_delta(jnp.asarray(delta), jnp.asarray(z), alpha_inv))


_CONV_TRAIN = [  # (N, H, W, C, F, K, bh, sf)
    (2, 7, 9, 5, 12, 3, 2, 3 << 9),
    (2, 9, 7, 6, 10, 5, 4, 3 << 10),
    (1, 11, 13, 3, 16, 3, 8, 3 << 9),
    (3, 8, 8, 4, 8, 3, 3, 3 << 9),
]


@pytest.mark.parametrize("n,h,w_sp,c,f,k,bh,sf", _CONV_TRAIN)
@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
def test_conv_fwd_plain_matches_pallas(n, h, w_sp, c, f, k, bh, sf, alpha_inv):
    rng = np.random.default_rng(h * w_sp + c + alpha_inv)
    x, w = _train_fwd_operands(rng, (n, h, w_sp, c), (k, k, c, f))
    a, z = tconv_ref.stream_conv_fwd_ref(torch.from_numpy(x), torch.from_numpy(w), sf=sf,
                                         alpha_inv=alpha_inv, bh=bh)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    ja, jz = j_stream_conv_fwd(jx, jw, sf=sf, alpha_inv=alpha_inv, bh=bh, interpret=True)
    ra, rz = jconv_ref.stream_conv_fwd_ref(jx, jw, sf=sf, alpha_inv=alpha_inv)
    _eq(a, ja, ra)
    _eq(z, jz, rz)
    da, dz = tconv_ops.fused_conv_fwd(torch.from_numpy(x), torch.from_numpy(w), sf=sf,
                                      alpha_inv=alpha_inv)
    assert torch.equal(da, a) and torch.equal(dz, z)


@pytest.mark.parametrize("n,h,w_sp,c,f,k,bh,sf", _CONV_TRAIN)
@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
@pytest.mark.parametrize("with_z", [True, False])
def test_conv_grad_w_plain_matches_pallas(n, h, w_sp, c, f, k, bh, sf, alpha_inv, with_z):
    rng = np.random.default_rng(h * w_sp + c + alpha_inv + with_z)
    x = rng.integers(-127, 128, (n, h, w_sp, c)).astype(np.int32)
    delta, z = _train_grad_operands(rng, (n, h, w_sp, f))
    tz, jz = (torch.from_numpy(z), jnp.asarray(z)) if with_z else (None, None)
    got = tconv_ref.stream_conv_grad_w_ref(torch.from_numpy(x), torch.from_numpy(delta),
                                           kernel_size=k, z_star=tz, alpha_inv=alpha_inv,
                                           bh=bh)
    jx, jd = jnp.asarray(x), jnp.asarray(delta)
    _eq(got,
        j_stream_conv_grad_w(jx, jd, kernel_size=k, z_star=jz, alpha_inv=alpha_inv,
                             bh=bh, interpret=True),
        jconv_ref.stream_conv_grad_w_ref(jx, jd, kernel_size=k, z_star=jz,
                                         alpha_inv=alpha_inv))
    disp = tconv_ops.conv_grad_w(torch.from_numpy(x), torch.from_numpy(delta),
                                 kernel_size=k, z_star=tz, alpha_inv=alpha_inv)
    assert torch.equal(disp, got)


@pytest.mark.parametrize("fuse_bwd", [True, False])
def test_grad_ops_grad_w_matches_jax(fuse_bwd):
    """grad_ops' gradients (fused and the escape hatch) ≡ JAX's, grad_x
    included."""
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (6, 20)).astype(np.int32)
    w = rng.integers(-50, 50, (20, 9)).astype(np.int32)
    delta, z = _train_grad_operands(rng, (6, 9))
    args = [torch.from_numpy(a) for a in (x, w, delta)]
    gx, gw = tgrad_ops.linear_grads(*args, z_star=torch.from_numpy(z), alpha_inv=3,
                                    fuse_bwd=fuse_bwd)
    jgx, jgw = jgrad_ops.linear_grads(*[jnp.asarray(a) for a in (x, w, delta)],
                                      z_star=jnp.asarray(z), alpha_inv=3, fuse_bwd=fuse_bwd)
    _eq(gx, jgx)
    _eq(gw, jgw)
    # no z*: the learning/output layers' two plain matmuls
    gx, gw = tgrad_ops.linear_grads(*args)
    jgx, jgw = jgrad_ops.linear_grads(*[jnp.asarray(a) for a in (x, w, delta)])
    _eq(gx, jgx)
    _eq(gw, jgw)
    xc = rng.integers(-127, 128, (2, 6, 5, 4)).astype(np.int32)
    wc = rng.integers(-50, 50, (3, 3, 4, 7)).astype(np.int32)
    dc, zc = _train_grad_operands(rng, (2, 6, 5, 7))
    gx, gw = tgrad_ops.conv_grads(*[torch.from_numpy(a) for a in (xc, wc, dc)],
                                  z_star=torch.from_numpy(zc), fuse_bwd=fuse_bwd)
    jgx, jgw = jgrad_ops.conv_grads(*[jnp.asarray(a) for a in (xc, wc, dc)],
                                    z_star=jnp.asarray(zc), fuse_bwd=fuse_bwd)
    _eq(gx, jgx)
    _eq(gw, jgw)


def test_training_kernels_no_cpu_fallback():
    """CPU tensors never reach a kernel: the wrappers and backend='cuda'
    raise; materialise training runs its plain tensor code on the CPU,
    launching nothing."""
    x = torch.zeros((2, 4, 4, 3), dtype=torch.int32)
    w = torch.zeros((3, 3, 3, 5), dtype=torch.int32)
    g = torch.zeros((2, 4, 4, 5), dtype=torch.int32)
    x2, w2, g2 = torch.zeros((2, 6), dtype=torch.int32), \
        torch.zeros((6, 5), dtype=torch.int32), torch.zeros((2, 5), dtype=torch.int32)
    on_card = "on one CUDA device"
    with pytest.raises(ValueError, match=on_card):
        t_stream_conv_fwd(x, w, sf=256)
    with pytest.raises(ValueError, match=on_card):
        t_stream_conv_grad_w(x, g, kernel_size=3, z_star=g)
    with pytest.raises(ValueError, match=on_card):
        t_nitro_matmul_fwd(x2, w2, sf=256)
    with pytest.raises(ValueError, match=on_card):
        t_nitro_matmul_grad_w(x2, g2, g2)
    cuda_only = "backend='cuda' needs CUDA tensors"
    with pytest.raises(ValueError, match=cuda_only):
        tconv_ops.fused_conv_fwd(x, w, sf=256, backend="cuda")
    with pytest.raises(ValueError, match=cuda_only):
        tconv_ops.conv_grad_w(x, g, kernel_size=3, backend="cuda")
    with pytest.raises(ValueError, match=cuda_only):
        tmm_ops.fused_matmul_fwd(x2, w2, sf=256, backend="cuda")
    with pytest.raises(ValueError, match=cuda_only):
        tmm_ops.grad_w_matmul(x2, g2, g2, backend="cuda")
    a, z = tconv_ops.fused_conv_fwd(x, w, sf=256, conv_mode="materialise")
    assert a.shape == z.shape == (2, 4, 4, 5)
    assert tconv_ops.conv_grad_w(x, g, kernel_size=3, conv_mode="materialise").shape \
        == (3, 3, 3, 5)
    with pytest.raises(ValueError, match="alpha_inv"):
        tmm_ops.fused_matmul_fwd(x2, w2, sf=256, alpha_inv=0)
    assert t_stream_conv_fwd.launches.value == 0
    assert t_nitro_matmul_grad_w.launches.value == 0
