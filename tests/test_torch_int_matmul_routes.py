"""PyTorch port, ``int_matmul``'s routes on the card (``kernels/int_matmul``):
the pure-Python route rule ``plan`` at every call the main paths make and
at its edges, the LM's K-major int8 weight (``quantize_weight_int8``,
bitwise JAX's) and route W's arithmetic model (``int_matmul/ref.py``:
s32 sums folded every 16,384 columns into an unsigned total) ≡ JAX's
``int_matmul``.  The kernels themselves run only on the card
(``chip_smoke.py`` phase 11a holds each route bitwise there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import numerics as jnum
from repro.models import common as jcom
from repro_torch.configs import get_paper_config
from repro_torch.core import layers, les, numerics, prng
from repro_torch.kernels import grad_ops
from repro_torch.kernels.int_matmul import int_matmul as im
from repro_torch.kernels.int_matmul import plan, wgmma_matmul
from repro_torch.models import common as tcom

I8, I32 = torch.int8, torch.int32
B = 64  # the training batch


def _route(a_shape, a_strides, b_shape, b_strides, a_dtype=I32, b_dtype=I32, a_ptr=0, b_ptr=0):
    return plan(a_shape, a_dtype, a_strides, a_ptr, b_shape, b_dtype, b_strides, b_ptr)


def _step_calls(fan_ins):
    """One training step's int_matmul calls at batch 64, as a full-width
    CPU step records them: per learning / output layer of fan-in K the
    forward x·W, grad_x δ·Wᵀ (not in the first block) and grad_W xᵀ·δ,
    with the strides of the views they pass."""
    calls = []
    for k, grad_x in fan_ins:
        calls.append(((B, k), (k, 1), (k, 10), (10, 1)))
        if grad_x:
            calls.append(((B, 10), (10, 1), (10, k), (1, 10)))
        calls.append(((k, B), (1, k), (B, 10), (10, 1)))
    return calls


#: the learning and output layers' fan-ins of a VGG8B and an mlp4 step
VGG8B_STEP = _step_calls([(1024, False), (3200, True), (4096, True), (4096, True),
                          (2048, True), (2048, True), (2048, True), (1024, True)])
MLP4_STEP = _step_calls([(3000, False), (3000, True), (3000, True), (3000, True)])
#: an evaluation batch's calls (contiguous int32) and their routes
VGG8B_EVAL = [((65536, 27), (27, 128), "D"), ((65536, 1152), (1152, 256), "D"),
              ((16384, 2304), (2304, 256), "D"), ((16384, 2304), (2304, 512), "D"),
              ((4096, 4608), (4608, 512), "D"), ((1024, 4608), (4608, 512), "D"),
              ((B, 2048), (2048, 1024), "D"), ((B, 1024), (1024, 10), "T")]
MLP4_EVAL = [((B, 3072), (3072, 3000), "D"), ((B, 3000), (3000, 3000), "D"),
             ((B, 3000), (3000, 3000), "D"), ((B, 3000), (3000, 10), "T")]
#: the LM's int8 MLP products at llama3.2-1b's full width, batch 4 × seq 512
LM_INT8 = [(2048, 2048, 8192), (2048, 8192, 2048)]


def test_step_calls_take_route_t():
    """Every call of a full-width VGG8B (23) and mlp4 (11) step takes the
    one-launch thin route, strided views and all."""
    assert len(VGG8B_STEP) == 23 and len(MLP4_STEP) == 11
    for a_shape, a_strides, b_shape, b_strides in VGG8B_STEP + MLP4_STEP:
        assert _route(a_shape, a_strides, b_shape, b_strides) == "T", (a_shape, b_shape)


@pytest.mark.parametrize("arch,calls", [("vgg8b", 23), ("mlp4", 11)])
def test_recorded_step_calls_match_the_table(arch, calls):
    """A recorded CPU step (narrow widths, batch 64) makes its int_matmul
    calls with the stride patterns of the table above, and each takes
    route T with its real strides and pointers."""
    cfg = get_paper_config(arch, scale=0.0625)
    state = les.create_train_state(prng.PRNGKey(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-127, 128, (B, *cfg.input_shape)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 10, (B,)).astype(np.int32))
    seen = []

    def rec(a, b):
        seen.append((a.shape, a.stride(), b.shape, b.stride(),
                     plan(tuple(a.shape), a.dtype, a.stride(), a.data_ptr(),
                          tuple(b.shape), b.dtype, b.stride(), b.data_ptr())))
        return numerics.int_matmul(a, b)

    saved = layers.int_matmul, grad_ops.int_matmul
    layers.int_matmul = grad_ops.int_matmul = rec
    try:
        les.train_step(state, cfg, x, y, prng.PRNGKey(1))
    finally:
        layers.int_matmul, grad_ops.int_matmul = saved
    table = VGG8B_STEP if arch == "vgg8b" else MLP4_STEP
    assert len(seen) == calls
    for (a_shape, a_strides, b_shape, b_strides, route), want in zip(seen, table):
        assert route == "T"
        assert (_layout(a_shape, a_strides), _layout(b_shape, b_strides)) == \
            (_layout(want[0], want[1]), _layout(want[2], want[3]))


def _layout(shape, strides) -> str:
    """"rows" for a row-major operand, "cols" for the transposed view of one."""
    return {(shape[1], 1): "rows", (1, shape[0]): "cols"}.get(tuple(strides), "other")


@pytest.mark.parametrize("calls", [VGG8B_EVAL, MLP4_EVAL], ids=["vgg8b", "mlp4"])
def test_eval_calls_routes(calls):
    for a_shape, b_shape, want in calls:
        assert _route(a_shape, (a_shape[1], 1), b_shape, (b_shape[1], 1)) == want


@pytest.mark.parametrize("m,k,n", LM_INT8)
def test_lm_int8_products_take_route_w(m, k, n):
    """The LM's int8 products: route W with the K-major weight (the (K, N)
    view of an (N, K) tensor), W after one transpose pass with an N-major
    one; the same int32 operands go to route D."""
    assert _route((m, k), (k, 1), (k, n), (1, k), I8, I8) == "W"
    assert _route((m, k), (k, 1), (k, n), (n, 1), I8, I8) == "WT"
    assert _route((m, k), (k, 1), (k, n), (1, k)) == "D"


@pytest.mark.parametrize("case,want", [
    # K % 16 != 0: TMA's rows are 16-byte multiples
    (((256, 1000), (1000, 1), (1000, 256), (1, 1000), I8, I8), "D"),
    # a misaligned base, of a and of a K-major b
    (((256, 1024), (1024, 1), (1024, 256), (1, 1024), I8, I8, 8), "D"),
    (((256, 1024), (1024, 1), (1024, 256), (1, 1024), I8, I8, 0, 4), "D"),
    # a row stride that is not a multiple of 16 (a view of a wider tensor)
    (((256, 1024), (1032, 1), (1024, 256), (1, 1024), I8, I8), "D"),
    # an N-major int8 b, contiguous and a column slice of a wider one
    (((256, 1024), (1024, 1), (1024, 256), (256, 1), I8, I8), "WT"),
    (((256, 1024), (1024, 1), (1024, 200), (256, 1), I8, I8), "WT"),
    # a transposed int8 a is not K-major
    (((256, 1024), (1, 256), (1024, 256), (1, 1024), I8, I8), "D"),
    # int8 x int32, and the reverse
    (((256, 1024), (1024, 1), (1024, 256), (256, 1), I8, I32), "D"),
    (((256, 1024), (1024, 1), (1024, 256), (1, 1024), I32, I8), "D"),
    # thin int8 products, whatever their layout
    (((8, 1024), (1024, 1), (1024, 256), (1, 1024), I8, I8), "T"),
    (((64, 32), (32, 1), (32, 4096), (1, 32), I8, I8), "T"),
    (((5, 77), (77, 1), (77, 130), (130, 1), I8, I32), "T"),
    # the card's timings draw the lines: int32 on T to 2^26 multiply-adds
    # at a side of up to 128 and at any work at a side of 16, D past them
    # and wherever both sides are wide, however short K; route W's int8
    # on T to 2^25 multiply-adds, on W past them, however thin
    (((64, 4096), (4096, 1), (4096, 256), (256, 1)), "T"),
    (((128, 2048), (2048, 1), (2048, 128), (128, 1)), "T"),
    (((64, 8192), (8192, 1), (8192, 256), (256, 1)), "D"),
    (((4096, 2048), (2048, 1), (2048, 16), (16, 1)), "T"),
    (((4096, 2048), (2048, 1), (2048, 32), (32, 1)), "D"),
    (((4096, 16), (16, 1), (16, 512), (512, 1)), "D"),
    (((128, 2048), (2048, 1), (2048, 128), (1, 2048), I8, I8), "T"),
    (((16, 2048), (2048, 1), (2048, 2048), (1, 2048), I8, I8), "W"),
    (((4096, 32), (32, 1), (32, 512), (1, 32), I8, I8), "W"),
    (((256, 48), (48, 1), (48, 17), (1, 48), I8, I8), "T"),
], ids=["K%16", "a misaligned", "b misaligned", "a row stride", "N-major b",
        "N-major b slice", "a transposed", "int8 x int32", "int32 x int8", "thin M",
        "thin K", "thin mixed", "side 64 2^26", "side 128 2^25", "side 64 2^27",
        "side 16 2^27", "side 32 2^28", "short K wide", "int8 2^25", "int8 side 16 2^26",
        "int8 short K wide", "int8 little"])
def test_route_edges(case, want):
    assert _route(*case) == want


def test_nothing_else_is_taken():
    """No route takes floats, int16 (the wrapper lifts it), mismatched or
    too-large shapes, a thin product's strides past int32, or route D's
    grid past 65,535 row tiles: plan raises."""
    with pytest.raises(ValueError, match="int8 or int32"):
        _route((64, 64), (64, 1), (64, 64), (64, 1), torch.float32)
    with pytest.raises(ValueError, match="int8 or int32"):
        _route((64, 64), (64, 1), (64, 64), (64, 1), I32, torch.int16)
    with pytest.raises(ValueError, match="bad shapes"):
        _route((64, 63), (63, 1), (64, 64), (64, 1))
    with pytest.raises(ValueError, match="fit int32"):
        _route((2 ** 16, 64), (64, 1), (64, 2 ** 15), (2 ** 15, 1))
    with pytest.raises(ValueError, match="strides"):
        _route((8, 64), (2 ** 31, 1), (64, 64), (64, 1))
    with pytest.raises(ValueError, match="grid"):
        _route((64 * 65535 + 1, 64), (64, 1), (64, 17), (17, 1))
    with pytest.raises(ValueError, match="integer operands"):
        im._lift(torch.zeros(2, dtype=torch.float16))
    assert im._lift(torch.zeros(2, dtype=torch.int16)).dtype == I32


def test_int8_weight_is_k_major_and_jax_bitwise():
    """quantize_weight_int8 stores its int8 weight (N, K) row-major and
    returns the (K, N) view: values, dtype and shift bitwise JAX's, and
    the LM's product with it takes route W as it lies."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    jq, js = jcom.quantize_weight_int8(jnp.asarray(w))
    tq, ts = tcom.quantize_weight_int8(torch.from_numpy(w))
    assert tq.dtype == I8 and tq.shape == (512, 256) and tq.stride() == (1, 512)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    xq = torch.from_numpy(rng.integers(-127, 128, (512, 512)).astype(np.int8))
    assert plan(tuple(xq.shape), xq.dtype, xq.stride(), xq.data_ptr(),
                tuple(tq.shape), tq.dtype, tq.stride(), tq.data_ptr()) == "W"
    np.testing.assert_array_equal(numerics.int_matmul(xq, tq).numpy(),
                                  np.asarray(jnum.int_matmul(jnp.asarray(xq.numpy()), jq)))


def test_wgmma_model_wraps_as_jax_at_depth():
    """Route W's arithmetic at K = 131,072 with every term (−128)·(−128):
    eight 16,384-column s32 sums of 2²⁸ each (no accumulator past 2³¹),
    folded into an unsigned total of 2³¹, which wraps to −2³¹ as JAX's."""
    a = np.full((2, 131072), -128, np.int8)
    b = np.full((131072, 3), -128, np.int8)
    want = np.asarray(jnum.int_matmul(jnp.asarray(a), jnp.asarray(b)))
    assert (want == -2 ** 31).all()
    got = wgmma_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == I32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wgmma_model_matches_jax_on_ragged_full_range():
    rng = np.random.default_rng(8)
    a = rng.integers(-128, 128, (5, 40000)).astype(np.int8)
    b = rng.integers(-128, 128, (40000, 7)).astype(np.int8)
    np.testing.assert_array_equal(
        wgmma_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jnum.int_matmul(jnp.asarray(a), jnp.asarray(b))))
