"""PyTorch port, the exact integer matmul (``numerics.int_matmul``) ≡ the
JAX package's ``repro.core.numerics.int_matmul`` (an XLA int32 dot), and
the legacy fused-layer wrappers ``nitro_linear`` / ``nitro_conv2d`` ≡
JAX's.

On the CPU ``int_matmul`` is torch's integer ``@``; on the card it is the
hand-written integer GEMM (``kernels/int_matmul``), which cannot run here:
its arithmetic is held through ``nitro_matmul.ref.digit_matmul`` (the
split-K GEMM over exact base-256 digits it shares with #1/#2, as the
kernel computes it, with its per-split s32 check), and its wrapper's refusal of CPU tensors is tested.  All
bitwise, dtype included (tolerance zero).  The quickstart's float audit
counts 0 float tensors in a CPU train step of VGG8B and mlp4.
"""

import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import activations as jact
from repro.core import layers as jlayers
from repro.core import numerics as jnum
from repro.core import scaling as jscaling
from repro.kernels.nitro_matmul import ops as jops
from repro_torch.configs import get_paper_config
from repro_torch.core import les, numerics, prng
from repro_torch.core.numerics import int_matmul_ref
from repro_torch.kernels.int_matmul import int_matmul_cuda
from repro_torch.kernels.nitro_conv import ref as conv_ref
from repro_torch.kernels.nitro_matmul import nitro_conv2d, nitro_linear
from repro_torch.kernels.nitro_matmul import ops as tops
from repro_torch.kernels.nitro_matmul import ref as mm_ref

ROOT = Path(__file__).resolve().parents[1]
I32 = (-(2 ** 31), 2 ** 31)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _ints(rng, shape, lo, hi, dtype=np.int32):
    return rng.integers(lo, hi, shape).astype(dtype)


#: (label, a, b): the learning / output layers at batch 64 (VGG8B's linear
#: learning layer and output layer, mlp4's output layer; forward x·W and
#: grad_W xᵀ·δ with a wide δ), materialise conv shapes, ragged M/N/K, a
#: contraction deeper than 16,384 and full-range operands that wrap
def _cases():
    rng = np.random.default_rng(26)
    cases = [
        ("vgg8b linear lr fwd", _ints(rng, (64, 1024), -127, 128), _ints(rng, (1024, 10), -9, 10)),
        ("vgg8b linear lr grad_W", _ints(rng, (1024, 64), -127, 128),
         _ints(rng, (64, 10), -2 ** 22, 2 ** 22)),
        ("mlp4 output fwd", _ints(rng, (64, 3000), -127, 128), _ints(rng, (3000, 10), -9, 10)),
        ("mlp4 output grad_W", _ints(rng, (3000, 64), -127, 128),
         _ints(rng, (64, 10), -2 ** 22, 2 ** 22)),
        ("materialise conv fwd", _ints(rng, (2 * 8 * 8, 27), -127, 128),
         _ints(rng, (27, 16), -64, 65)),
        ("materialise conv grad_W", _ints(rng, (27, 2 * 8 * 8), -127, 128),
         _ints(rng, (2 * 8 * 8, 16), -2 ** 20, 2 ** 20)),
        ("int8 ragged", _ints(rng, (37, 100), -128, 128, np.int8),
         _ints(rng, (100, 23), -128, 128, np.int8)),
        ("int8 x int32", _ints(rng, (5, 77), -128, 128, np.int8), _ints(rng, (77, 13), *I32)),
        ("deep K", _ints(rng, (3, 40000), -127, 128), _ints(rng, (40000, 5), -2 ** 24, 2 ** 24)),
        ("full range", _ints(rng, (7, 300), *I32), _ints(rng, (300, 9), *I32)),
    ]
    a, b = cases[-1][1], cases[-1][2]
    a[0], b[:, 0], a[1], b[:, 1] = -2 ** 31, -2 ** 31, 2 ** 31 - 1, 2 ** 31 - 1
    return cases


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_int_matmul_cpu_matches_jax(case):
    """Dispatch on the CPU: torch's integer ``@``, lifted to int32."""
    _, a, b = case
    want = jnum.int_matmul(jnp.asarray(a), jnp.asarray(b))
    _eq(numerics.int_matmul(torch.from_numpy(a), torch.from_numpy(b)), want)
    _eq(int_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_arithmetic_matches_jax(case):
    """The kernel's split-K digit GEMM (only the digit pairs the data
    needs; per split no s32 sum overflows; the splits add mod 2³²)."""
    _, a, b = case
    want = jnum.int_matmul(jnp.asarray(a), jnp.asarray(b))
    _eq(mm_ref.digit_matmul(torch.from_numpy(a), torch.from_numpy(b)), want)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in ("full range", "deep K")],
                         ids=["deep K", "full range"])
def test_limb_plain_version_matches_jax(case):
    """The card's plain version (float64 GEMMs over 16-bit limbs), run on
    CPU tensors: exact at wrap and depth."""
    _, a, b = case
    _eq(numerics._matmul_f64_exact(torch.from_numpy(a), torch.from_numpy(b)),
        jnum.int_matmul(jnp.asarray(a), jnp.asarray(b)))


def test_wrapper_refuses_cpu_tensors_and_nothing_falls_back():
    """The kernel wrapper takes CUDA tensors only, and ``int_matmul`` has
    no fallback: on the card it calls the kernel (here it cannot)."""
    a = torch.ones((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        int_matmul_cuda(a, a.T)
    with pytest.raises(ValueError, match="integer operands"):
        int_matmul_cuda(a.float(), a.T.float())
    src = inspect.getsource(numerics.int_matmul)
    assert "int_matmul_cuda" in src and "try" not in src and "_matmul_f64_exact" not in src


@pytest.mark.parametrize("module", [mm_ref, conv_ref], ids=["nitro_matmul", "nitro_conv"])
def test_plain_versions_use_the_plain_product(module):
    """Every kernel's plain version multiplies through ``int_matmul_ref``,
    so a fault of the card's integer GEMM cannot hide on both sides of a
    parity check."""
    src = inspect.getsource(module)
    assert "int_matmul_ref(" in src
    assert "int_matmul(" not in src.replace("int_matmul_ref(", "")


@pytest.fixture(scope="module")
def quickstart():
    spec = importlib.util.spec_from_file_location(
        "examples_torch_quickstart", ROOT / "examples_torch" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["vgg8b", "mlp4"])
def test_quickstart_audit_counts_no_float_in_a_cpu_step(quickstart, arch):
    """The quickstart's float audit over one train step of each arch's
    learning / output layers (their int_matmul): 0 float tensors."""
    cfg = get_paper_config(arch, scale=0.0625)
    state = les.create_train_state(prng.PRNGKey(0), cfg, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-127, 128, (4, *cfg.input_shape)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 10, (4,)).astype(np.int32))
    audit = quickstart.audit_train_step(state, cfg, x, y, prng.PRNGKey(1))
    assert audit.n_float == 0, dict(audit.ops)


# ---------------------------------------------------------------------------
# A3: the legacy fused-layer wrappers (tests/test_kernels.py's cases)
# ---------------------------------------------------------------------------


def test_nitro_linear_matches_jax():
    """nitro_linear ≡ JAX's (Pallas interpret) and the layer pipeline."""
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (4, 10, 48)).astype(np.int32)
    w = rng.integers(-60, 61, (48, 24)).astype(np.int32)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        want = jops.nitro_linear(jnp.asarray(x), jnp.asarray(w), use_kernel=True,
                                 interpret=True)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        got = nitro_linear(torch.from_numpy(x), torch.from_numpy(w), use_kernel=True,
                           interpret=True)
    _eq(got, want)
    _eq(nitro_linear(torch.from_numpy(x), torch.from_numpy(w)), want)


def test_nitro_conv2d_matches_jax():
    """nitro_conv2d ≡ JAX's and conv_forward → scale → relu."""
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (2, 6, 6, 3)).astype(np.int32)
    w = rng.integers(-50, 51, (3, 3, 3, 8)).astype(np.int32)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        want = jops.nitro_conv2d(jnp.asarray(x), jnp.asarray(w), use_kernel=True,
                                 interpret=True)
    z, _ = jlayers.conv_forward({"w": jnp.asarray(w)}, jnp.asarray(x))
    np.testing.assert_array_equal(
        np.asarray(want),
        np.asarray(jact.nitro_relu(jscaling.scale_forward(z, jscaling.conv_scale_factor(3, 3)),
                                   10)))
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        got = nitro_conv2d(torch.from_numpy(x), torch.from_numpy(w), use_kernel=True,
                           interpret=True)
    _eq(got, want)
    _eq(nitro_conv2d(torch.from_numpy(x), torch.from_numpy(w), apply_relu=False),
        jops.nitro_conv2d(jnp.asarray(x), jnp.asarray(w), apply_relu=False))


def test_legacy_knobs_warn_raise_and_map():
    """Explicit knobs warn; use_kernel=False with interpret=True raises, as
    in JAX; the defaults are silent; the port's mapping of the knobs."""
    import warnings

    x = torch.ones((4, 16), dtype=torch.int32)
    w = torch.ones((16, 8), dtype=torch.int32)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        nitro_linear(x, w, use_kernel=False)
    with pytest.raises(ValueError, match="contradictory"), \
            pytest.warns(DeprecationWarning):
        nitro_linear(x, w, use_kernel=False, interpret=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        nitro_linear(x, w)
        assert tops._legacy_backend(None, None) == "auto"
    with pytest.warns(DeprecationWarning):
        assert [tops._legacy_backend(u, i) for u, i in
                ((True, None), (True, False), (True, True), (None, True), (False, None))] == \
            ["auto", "cuda", "reference", "reference", "reference"]
    with pytest.raises(ValueError, match="needs CUDA tensors"), \
            pytest.warns(DeprecationWarning):
        nitro_linear(x, w, use_kernel=True, interpret=False)
