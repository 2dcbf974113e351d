"""PyTorch port on a CUDA card: each kernel ≡ its plain version, bitwise,
and the CUDA training step ≡ the plain one.

This file imports torch and the port only (no JAX), so it runs where the
kernels do:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Every test is marked ``gpu`` and skips, from a fixture, without a card.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_paper_config
from repro_torch.core import model as M
from repro_torch.core import prng
from repro_torch.infer import compile_plan, freeze
from repro_torch.core import les
from repro_torch.core import optimizer as opt
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.integer_sgd import (
    integer_sgd_ref,
    integer_sgd_update,
    integer_sgd_update_many,
)
from repro_torch.kernels.integer_sgd.integer_sgd import (
    TABLE_STATES,
    TABLE_TENSORS,
    plan_tables,
)
from repro_torch.kernels.maxpool import (
    maxpool_bwd_cuda,
    maxpool_bwd_ref,
    maxpool_fwd_cuda,
    maxpool_fwd_ref,
)
from repro_torch.kernels.nitro_conv.nitro_conv import (
    stream_conv,
    stream_conv_fwd,
    stream_conv_grad_w,
    stream_conv_grad_w_opt,
    stream_conv_grad_x,
)
from repro_torch.kernels.nitro_conv.ops import conv_grad_x
from repro_torch.kernels.nitro_conv.ref import (
    stream_conv_fwd_ref,
    stream_conv_grad_w_opt_ref,
    stream_conv_grad_w_ref,
    stream_conv_grad_x_ref,
    stream_conv_ref,
)
from repro_torch.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul,
    nitro_matmul_fwd,
    nitro_matmul_grad_w,
    nitro_matmul_grad_w_opt,
    nitro_matmul_grad_x,
)
from repro_torch.kernels.nitro_matmul.ref import (
    nitro_matmul_fwd_ref,
    nitro_matmul_grad_w_opt_ref,
    nitro_matmul_grad_w_ref,
    nitro_matmul_grad_x_ref,
    nitro_matmul_ref,
)

_T = {"int8": torch.int8, "int32": torch.int32}
_MM_CASES = [((5, 7, 3), 3 << 5), ((64, 300, 70), 3 << 8), ((33, 2048, 10), 3 << 9)]
_CONV_CASES = [  # (N, H, W, C, F, K, pool, operands, bh, sf)
    (2, 7, 9, 5, 12, 3, True, "int8", 2, 3 << 5),
    (2, 9, 7, 6, 10, 5, False, "int32", 4, 3 << 6),
    (1, 11, 13, 3, 16, 3, True, "int32", 8, 3 << 4),
    (3, 8, 8, 4, 8, 3, False, "int8", 3, 3 << 5),
    (2, 6, 5, 3, 7, 5, True, "int8", 1, 3 << 5),
    (2, 16, 100, 400, 40, 3, True, "int8", 8, 256 * 3600),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _ints(g, shape, dtype, device):
    return torch.randint(-127, 128, shape, generator=g).to(dtype).to(device)


@pytest.mark.gpu
def test_nitro_matmul_matches_plain(cuda_device):
    """int8 and int32 operands, ReLU on and off, int8 and int32 out; then
    int8 x whose rows are not 16-byte aligned (the x pre-pass) and every
    digit path of the int32 operands, each call twice."""
    g = torch.Generator().manual_seed(0)
    for (m, k, n), sf in _MM_CASES:
        for od in ("int8", "int32"):
            x, w = _ints(g, (m, k), _T[od], cuda_device), _ints(g, (k, n), _T[od], cuda_device)
            for relu, out in ((True, torch.int8), (False, torch.int32)):
                kw = dict(sf=sf, apply_relu=relu, out_dtype=out, operand_dtype=od)
                got = nitro_matmul(x, w, **kw)
                want = nitro_matmul_ref(x, w, **kw)
                torch.cuda.synchronize()
                assert got.dtype == want.dtype and torch.equal(got, want)
        buf = _ints(g, (m * k + 1,), torch.int8, cuda_device)
        x, w = buf[1:].view(m, k), _ints(g, (k, n), torch.int8, cuda_device)
        kw = dict(sf=sf, out_dtype=torch.int8, operand_dtype="int8")
        assert torch.equal(nitro_matmul(x, w, **kw), nitro_matmul_ref(x, w, **kw))
    for m, k, n in _MM_DIGIT_SHAPES:
        for x_lim in _LIMS:
            for w_lim in _LIMS:
                x, w = _lim_ints(g, (m, k), x_lim, cuda_device), _lim_ints(g, (k, n), w_lim, cuda_device)
                relu = x_lim < w_lim
                kw = dict(sf=27 << 8, apply_relu=relu, out_dtype=torch.int8 if relu else torch.int32)
                want = nitro_matmul_ref(x, w, **kw)
                for _ in range(2):
                    got = nitro_matmul(x, w, **kw)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype and torch.equal(got, want), (m, k, n)


#: bounds of x and w on the forward conv kernels' digit paths: one, two,
#: three and four digits (the last with INT32_MIN/MAX planted)
_LIMS = (100, 20000, 2 ** 20, 2 ** 31 - 1)
#: (N, H, W, C, F, K): C = 5 (patch planes), 16 with odd W and 64 with K = 5
#: and odd H and W (NHWC planes)
_DIGIT_SHAPES = [(2, 7, 9, 5, 12, 3), (2, 6, 5, 16, 20, 3), (1, 9, 7, 64, 70, 5)]
#: K²C = 18,432: the GEMM folds its s32 sums once
_FOLD_SHAPE = (1, 4, 5, 2048, 8, 3)


def _lim_ints(g, shape, lim, device):
    t = _wide(g, shape, lim, device)
    if lim == 2 ** 31 - 1:
        t.view(-1)[:2] = torch.tensor([-(2 ** 31), 2 ** 31 - 1], dtype=torch.int32)[:t.numel()]
    return t


@pytest.mark.gpu
def test_stream_conv_matches_plain(cuda_device):
    """int8 and int32 operands at ragged shapes; then every digit path of
    the tensor-core kernel — x and w of one to four digits, the pool with
    odd H or W, int8 and int32 out, with and without the ReLU — the fold,
    an empty batch and the grad_x route without z* (sf = 1, full-range δ
    and w)."""
    g = torch.Generator().manual_seed(1)
    for n, h, w_sp, c, f, k, pool, od, bh, sf in _CONV_CASES:
        x = _ints(g, (n, h, w_sp, c), _T[od], cuda_device)
        w = _ints(g, (k, k, c, f), _T[od], cuda_device)
        kw = dict(sf=sf, pool=pool, out_dtype=torch.int8, operand_dtype=od, bh=bh)
        got = stream_conv(x, w, **kw)
        want = stream_conv_ref(x, w, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)
    for n, h, w_sp, c, f, k in _DIGIT_SHAPES:
        for x_lim in _LIMS:
            for w_lim in _LIMS:
                x = _lim_ints(g, (n, h, w_sp, c), x_lim, cuda_device)
                w = _lim_ints(g, (k, k, c, f), w_lim, cuda_device)
                for pool, out, relu in ((True, torch.int8, True), (False, torch.int32, False)):
                    kw = dict(sf=3 << 9, pool=pool, out_dtype=out, apply_relu=relu)
                    got = stream_conv(x, w, **kw)
                    want = stream_conv_ref(x, w, **kw)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype and torch.equal(got, want), \
                        (n, h, w_sp, c, f, k, x_lim, w_lim, pool)
    x = _lim_ints(g, _FOLD_SHAPE[:4], 2 ** 31 - 1, cuda_device)
    w = _lim_ints(g, (3, 3, 2048, 8), 2 ** 31 - 1, cuda_device)
    for pool in (False, True):
        got = stream_conv(x, w, sf=27 << 8, pool=pool, apply_relu=False)
        assert torch.equal(got, stream_conv_ref(x, w, sf=27 << 8, pool=pool, apply_relu=False))
    x = _lim_ints(g, (0, 5, 7, 16), 100, cuda_device)
    w = _lim_ints(g, (3, 3, 16, 4), 100, cuda_device)
    got = stream_conv(x, w, sf=3, pool=True, out_dtype=torch.int8)
    assert got.shape == (0, 2, 3, 4) and got.dtype == torch.int8
    before = stream_conv.launches.value
    for n, h, w_sp, c, f, k in _DIGIT_SHAPES:
        delta = _lim_ints(g, (n, h, w_sp, f), 2 ** 31 - 1, cuda_device)
        w = _lim_ints(g, (k, k, c, f), 2 ** 31 - 1, cuda_device)
        got = conv_grad_x(delta, w, backend="cuda")
        want = stream_conv_grad_x_ref(delta, w)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert stream_conv.launches.value == before + len(_DIGIT_SHAPES)


@pytest.mark.gpu
def test_cuda_plan_matches_reference_plan(cuda_device):
    cfg = get_paper_config("vgg8b", scale=0.25)
    fm = freeze(M.init_params(prng.PRNGKey(2), cfg, device="cpu"), cfg)
    x = np.random.default_rng(2).integers(-127, 128, (5, *cfg.input_shape)).astype(np.int32)
    got = compile_plan(fm, device=cuda_device).logits(x)
    want = compile_plan(fm, device=cuda_device, backend="reference").logits(x)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(compile_plan(fm, device="cpu").logits(x), want.cpu())


def _wide(g, shape, lim, device):
    return torch.randint(-lim, lim, shape, generator=g).to(torch.int32).to(device)


_MM_TRAIN = [((5, 7, 3), 3 << 8), ((64, 300, 70), 3 << 10), ((1000, 20, 10), 3 << 4)]


#: ragged matmul shapes on the digit paths: M of 1 to 65, K not a multiple
#: of 16, K = 0 and K deep enough for three splits, N = 10 and ragged
_MM_DIGIT_SHAPES = [(1, 7, 10), (3, 100, 10), (33, 300, 70), (65, 130, 67), (2, 0, 5),
                    (3, 40000, 10)]


@pytest.mark.gpu
def test_nitro_matmul_fwd_matches_plain(cuda_device):
    """The training shapes at α_inv 1, 2 and 10; then every digit path of
    the split-K tensor-core kernel — x and w of one to four digits — each
    call twice (a split slot or arrival counter left wrong would show),
    and w with one 64×64 tile of four digits among one-digit tiles."""
    g = torch.Generator().manual_seed(3)
    for (m, k, n), sf in _MM_TRAIN:
        x, w = _ints(g, (m, k), torch.int32, cuda_device), _wide(g, (k, n), 2 ** 10, cuda_device)
        for alpha_inv in (1, 2, 10):
            got = nitro_matmul_fwd(x, w, sf=sf, alpha_inv=alpha_inv)
            want = nitro_matmul_fwd_ref(x, w, sf=sf, alpha_inv=alpha_inv)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    for m, k, n in _MM_DIGIT_SHAPES:
        cases = [(_lim_ints(g, (m, k), x_lim, cuda_device), _lim_ints(g, (k, n), w_lim, cuda_device))
                 for x_lim in _LIMS for w_lim in _LIMS]
        w = _wide(g, (k, n), 5, cuda_device)
        if w.numel():
            w[k // 2, n // 2] = -(2 ** 31)
        cases.append((_wide(g, (m, k), 128, cuda_device), w))
        for x, w in cases:
            want = nitro_matmul_fwd_ref(x, w, sf=3 << 9, alpha_inv=10)
            for _ in range(2):
                got = nitro_matmul_fwd(x, w, sf=3 << 9, alpha_inv=10)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b), (m, k, n)
    _, arrivals = cuda_lib.split_workspace(cuda_device, 65, 70)
    assert not bool(arrivals.any())


#: (B, M, N) of the linear grad_W kernels: contractions shorter than one
#: MMA step (1, 3), VGG8B's linear and mlp4's layers at batch 64, 4,096 and
#: 16,385 samples (64 and 257 chunks), M and N off the 128 × 64 tile
_GRAD_W_SHAPES = [(1, 63, 65), (3, 129, 1), (16385, 65, 63), (5, 7, 3), (64, 300, 70),
                  (1000, 20, 10), (4096, 300, 70), (64, 2048, 1024), (64, 3072, 3000),
                  (64, 3000, 3000)]


def _grad_w_operands(g, b, m, n, x_lim, d_lim, device):
    """x and δ within ±lim (INT32_MIN/MAX planted at the full range), z*
    over every NITRO-ReLU segment but 0 where the extremes sit, so the
    masked δ keeps them."""
    x, delta = _lim_ints(g, (b, m), x_lim, device), _lim_ints(g, (b, n), d_lim, device)
    z = _wide(g, (b, n), 300, device)
    z.view(-1)[:2] = 0
    return x, delta, z


@pytest.mark.gpu
def test_nitro_matmul_grad_w_matches_plain(cuda_device):
    """Every digit path — x and masked δ of one to four digits, 16
    variants — at every shape of _GRAD_W_SHAPES, α_inv 10, each call twice
    (the same bits); then α_inv 1 and 2 on full-range operands."""
    g = torch.Generator().manual_seed(4)
    for b, m, n in _GRAD_W_SHAPES:
        for x_lim in _LIMS:
            for d_lim in _LIMS:
                x, delta, z = _grad_w_operands(g, b, m, n, x_lim, d_lim, cuda_device)
                want = nitro_matmul_grad_w_ref(x, delta, z, alpha_inv=10)
                for _ in range(2):
                    got = nitro_matmul_grad_w(x, delta, z, alpha_inv=10)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype and torch.equal(got, want), \
                        (b, m, n, x_lim, d_lim)
        x, delta, z = _grad_w_operands(g, b, m, n, 2 ** 31 - 1, 2 ** 31 - 1, cuda_device)
        for alpha_inv in (1, 2):
            got = nitro_matmul_grad_w(x, delta, z, alpha_inv=alpha_inv)
            want = nitro_matmul_grad_w_ref(x, delta, z, alpha_inv=alpha_inv)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want), (b, m, n, alpha_inv)


_CONV_TRAIN = [  # (N, H, W, C, F, K, sf)
    (2, 7, 9, 5, 12, 3, 3 << 9),
    (2, 9, 7, 6, 10, 5, 3 << 10),
    (3, 33, 31, 3, 70, 3, 3 << 9),
    (1, 12, 90, 150, 36, 3, 3 << 11),
]


@pytest.mark.gpu
def test_stream_conv_fwd_matches_plain(cuda_device):
    """The training shapes at α_inv 1 and 10; then every digit path — x
    and w of one to four digits, int8-dtype x with int8 and int32 w — the
    fold and an empty batch."""
    g = torch.Generator().manual_seed(5)
    for n, h, w_sp, c, f, k, sf in _CONV_TRAIN:
        x = _ints(g, (n, h, w_sp, c), torch.int32, cuda_device)
        w = _wide(g, (k, k, c, f), 2 ** 10, cuda_device)
        for alpha_inv in (1, 10):
            got = stream_conv_fwd(x, w, sf=sf, alpha_inv=alpha_inv)
            want = stream_conv_fwd_ref(x, w, sf=sf, alpha_inv=alpha_inv)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    cases = []
    for n, h, w_sp, c, f, k in _DIGIT_SHAPES:
        for x_lim in _LIMS:
            for w_lim in _LIMS:
                cases.append((_lim_ints(g, (n, h, w_sp, c), x_lim, cuda_device),
                              _lim_ints(g, (k, k, c, f), w_lim, cuda_device)))
        cases.append((_ints(g, (n, h, w_sp, c), torch.int8, cuda_device),
                      _ints(g, (k, k, c, f), torch.int8, cuda_device)))
        cases.append((_ints(g, (n, h, w_sp, c), torch.int8, cuda_device),
                      _lim_ints(g, (k, k, c, f), 20000, cuda_device)))
    cases.append((_lim_ints(g, _FOLD_SHAPE[:4], 2 ** 31 - 1, cuda_device),
                  _lim_ints(g, (3, 3, 2048, 8), 2 ** 31 - 1, cuda_device)))
    cases.append((_lim_ints(g, (0, 5, 7, 16), 100, cuda_device),
                  _lim_ints(g, (3, 3, 16, 4), 100, cuda_device)))
    for x, w in cases:
        got = stream_conv_fwd(x, w, sf=3 << 9, alpha_inv=10)
        want = stream_conv_fwd_ref(x, w, sf=3 << 9, alpha_inv=10)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b), \
                (tuple(x.shape), x.dtype, w.dtype)


#: x bounds of the conv grad_W cases: int8 (one digit plane) and the
#: whole int32 range (four: the ten digit products i + j ≤ 3)
_X_LIMS = (128, 2 ** 31 - 1)
#: δ bounds: one, two, three and four digits (the last with the extremes)
_D_LIMS = (100, 20000, 2 ** 20, 2 ** 31 - 1)


def _digit_operands(g, shape, x_lim, d_lim, device):
    """x and δ within ±lim; at the full int32 range INT32_MIN/MAX planted."""
    n, h, w_sp, c, f = shape
    x = _wide(g, (n, h, w_sp, c), x_lim, device)
    delta = _wide(g, (n, h, w_sp, f), d_lim, device)
    ext = torch.tensor([-(2 ** 31), 2 ** 31 - 1], dtype=torch.int32, device=device)
    for t, lim in ((x, x_lim), (delta, d_lim)):
        if lim == 2 ** 31 - 1:
            t.view(-1)[:2] = ext[:t.numel()]
    return x, delta


@pytest.mark.gpu
def test_stream_conv_grad_w_matches_plain(cuda_device):
    """Every digit path of the tensor-core kernel: x in int8 and full-range,
    δ needing one to four digits, with z* at α_inv 1 and 10 and without;
    ragged P, C = 3, 5, 6 and 150, F = 10–70, K = 3 and 5."""
    g = torch.Generator().manual_seed(6)
    for n, h, w_sp, c, f, k, _ in _CONV_TRAIN:
        z = _wide(g, (n, h, w_sp, f), 300, cuda_device)
        for x_lim in _X_LIMS:
            for d_lim in _D_LIMS:
                x, delta = _digit_operands(g, (n, h, w_sp, c, f), x_lim, d_lim, cuda_device)
                for z_star, alpha_inv in ((z, 1), (z, 10), (None, 10)):
                    got = stream_conv_grad_w(x, delta, kernel_size=k, z_star=z_star,
                                             alpha_inv=alpha_inv)
                    want = stream_conv_grad_w_ref(x, delta, kernel_size=k, z_star=z_star,
                                                  alpha_inv=alpha_inv)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype and torch.equal(got, want), \
                        (n, h, w_sp, c, f, k, x_lim, d_lim, z_star is None, alpha_inv)


@pytest.mark.gpu
def test_cuda_train_steps_match_reference(cuda_device):
    """Two VGG8B steps at scale 0.25 through the kernels ≡ the plain step."""
    cfg = get_paper_config("vgg8b", scale=0.25)
    rng = np.random.default_rng(7)
    states = {b: les.create_train_state(prng.PRNGKey(1), cfg, device=cuda_device)
              for b in ("cuda", "reference")}
    for it in range(2):
        x = torch.from_numpy(rng.integers(-127, 128, (16, *cfg.input_shape))
                             .astype(np.int32)).to(cuda_device)
        y = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32)).to(cuda_device)
        out = {b: les.train_step(states[b], cfg, x, y, prng.PRNGKey(it), backend=b)
               for b in states}
        states = {b: out[b][0] for b in out}
        for f in ("loss", "correct", "local_losses"):
            assert torch.equal(getattr(out["cuda"][1], f), getattr(out["reference"][1], f))
    got, want = states["cuda"], states["reference"]
    for bg, bw in zip(got.params["blocks"], want.params["blocks"]):
        for part in ("fw", "lr"):
            assert torch.equal(bg[part]["w"], bw[part]["w"])
    assert torch.equal(got.params["output"]["w"], want.params["output"]["w"])
    assert int(got.step) == 2 and torch.equal(got.opt_fw.gamma_inv, want.opt_fw.gamma_inv)


# (γ_inv, η_inv): decay on, decay off with γ_inv = 1, a negative γ_inv, the
# forward layers' γ after two plateaus, and a γ_inv that floors most
# gradients to 0 or −1
_SGD_STATES = [(512, 12000), (1, 0), (-3, 5), (512 * 640 * 9, 3), (2 ** 31 - 1, 0)]


@pytest.mark.gpu
def test_integer_sgd_update_matches_plain(cuda_device):
    """Full-range int32 W and g (the update wraps), ragged sizes, a view
    whose start is not 16-byte aligned (the scalar path), γ_inv as a 0-d
    tensor on the card or an int; then many-tensor calls: aligned tensors
    beside base[1:] views, two states in one launch, and more tensors than
    a table holds (one launch per table)."""
    g = torch.Generator().manual_seed(8)
    for shape in ((1,), (7,), (129,), (3, 3, 3, 128), (2048, 1024)):
        w = _wide(g, shape, 2 ** 31 - 1, cuda_device)
        grad = _wide(g, shape, 2 ** 31 - 1, cuda_device)
        for gamma, eta in _SGD_STATES:
            state = opt.init_state(gamma, eta, device=cuda_device)
            got = integer_sgd_update(w, grad, state.gamma_inv, state.eta_inv)
            want = integer_sgd_ref(w, grad, gamma, eta)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want)
    w, grad = _wide(g, (1001,), 2 ** 20, cuda_device), _wide(g, (1001,), 2 ** 20, cuda_device)
    got = integer_sgd_update(w[1:], grad[1:], 7, 3)
    assert torch.equal(got, integer_sgd_ref(w[1:], grad[1:], 7, 3))
    assert integer_sgd_update.launches.value > 0
    states = [opt.init_state(gamma, eta, device=cuda_device) for gamma, eta in _SGD_STATES]
    for n_tensors, n_states in ((5, 2), (TABLE_TENSORS, 2), (2 * TABLE_TENSORS + 3, 2),
                                (12, len(states))):
        ws, gs, ss = [], [], []
        for i in range(n_tensors):
            n = [1, 3, 4, 5, 1001, 4096, 4097, 70_000][i % 8]
            base_w, base_g = (_wide(g, (n + 1,), 2 ** 31 - 1, cuda_device) for _ in range(2))
            cut = slice(1, None) if i % 3 == 1 else slice(0, n)  # every third a view
            ws.append(base_w[cut])
            gs.append(base_g[cut])
            ss.append(states[i % n_states])
        ws.append(torch.empty(0, dtype=torch.int32, device=cuda_device))
        gs.append(ws[-1])
        ss.append(states[0])
        integer_sgd_update.launches.reset()
        got = integer_sgd_update_many(ws, gs, ss)
        torch.cuda.synchronize()
        tables = len(plan_tables([t.numel() for t in ws], [id(s) for s in ss]))
        assert integer_sgd_update.launches.value == tables
        assert n_states > TABLE_STATES or tables == -(-n_tensors // TABLE_TENSORS)
        for w_, g_, s_, out in zip(ws, gs, ss, got):
            want = integer_sgd_ref(w_, g_, s_.gamma_inv, s_.eta_inv)
            assert out.dtype == torch.int32 and torch.equal(out, want)
            assert out.numel() == 0 or out.data_ptr() != w_.data_ptr()


@pytest.mark.gpu
def test_nitro_matmul_grad_w_opt_matches_plain(cuda_device):
    """Every digit path at every shape of _GRAD_W_SHAPES under two
    optimiser states, each call twice (the same bits); then every state of
    _SGD_STATES on full-range operands, W full range (the update wraps)."""
    g = torch.Generator().manual_seed(9)
    for b, m, n in _GRAD_W_SHAPES:
        w = _lim_ints(g, (m, n), 2 ** 31 - 1, cuda_device)
        for x_lim in _LIMS:
            for d_lim in _LIMS:
                x, delta, z = _grad_w_operands(g, b, m, n, x_lim, d_lim, cuda_device)
                for (gamma, eta), alpha_inv in zip(_SGD_STATES[:2], (10, 1)):
                    want = nitro_matmul_grad_w_opt_ref(x, delta, z, w, gamma, eta,
                                                       alpha_inv=alpha_inv)
                    for _ in range(2):
                        got = nitro_matmul_grad_w_opt(x, delta, z, w, gamma, eta,
                                                      alpha_inv=alpha_inv)
                        torch.cuda.synchronize()
                        assert got.dtype == want.dtype and torch.equal(got, want), \
                            (b, m, n, x_lim, d_lim, gamma)
        x, delta, z = _grad_w_operands(g, b, m, n, 2 ** 31 - 1, 2 ** 20, cuda_device)
        for (gamma, eta), alpha_inv in zip(_SGD_STATES, (10, 1, 2, 10, 3)):
            got = nitro_matmul_grad_w_opt(x, delta, z, w, gamma, eta, alpha_inv=alpha_inv)
            want = nitro_matmul_grad_w_opt_ref(x, delta, z, w, gamma, eta,
                                               alpha_inv=alpha_inv)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want), (b, m, n, gamma)


@pytest.mark.gpu
def test_stream_conv_grad_w_opt_matches_plain(cuda_device):
    """Each optimiser state, each call twice (a second call proves the
    workspace and counters were left zero), over the digit paths; then
    the shared workspace is zero and #4, which shares it, still bitwise."""
    g = torch.Generator().manual_seed(10)
    for n, h, w_sp, c, f, k, _ in _CONV_TRAIN:
        z = _wide(g, (n, h, w_sp, f), 300, cuda_device)
        w = _wide(g, (k, k, c, f), 2 ** 31 - 1, cuda_device)
        for x_lim, d_lim in ((128, 2 ** 20), (128, 100), (2 ** 31 - 1, 2 ** 31 - 1)):
            x, delta = _digit_operands(g, (n, h, w_sp, c, f), x_lim, d_lim, cuda_device)
            for (gamma, eta), alpha_inv in zip(_SGD_STATES, (10, 1, 2, 10, 3)):
                for _ in range(2):
                    got = stream_conv_grad_w_opt(x, delta, z, w, gamma, eta,
                                                 kernel_size=k, alpha_inv=alpha_inv)
                    want = stream_conv_grad_w_opt_ref(x, delta, z, w, gamma, eta,
                                                      kernel_size=k, alpha_inv=alpha_inv)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype and torch.equal(got, want)
        ws, arrivals = cuda_lib.split_workspace(x.device, k * k * c, f, cuda_lib.DIGIT_TILE)
        assert not ws.any() and not arrivals.any()
    x, delta = _digit_operands(g, (0, 5, 7, 3, 9), 128, 100, cuda_device)  # P = 0
    w = _wide(g, (3, 3, 3, 9), 2 ** 31 - 1, cuda_device)
    got = stream_conv_grad_w_opt(x, delta, delta, w, 7, 3, kernel_size=3)
    assert torch.equal(got, stream_conv_grad_w_opt_ref(x, delta, delta, w, 7, 3, kernel_size=3))
    x = _wide(g, (4096, 300), 2 ** 31 - 1, cuda_device)
    delta, z = _wide(g, (4096, 70), 2 ** 20, cuda_device), _wide(g, (4096, 70), 300, cuda_device)
    w = _wide(g, (300, 70), 2 ** 31 - 1, cuda_device)
    got = nitro_matmul_grad_w_opt(x, delta, z, w, 512, 12000)
    want = nitro_matmul_grad_w_opt_ref(x, delta, z, w, 512, 12000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_fuse_opt_steps_match_split_steps(cuda_device):
    """Two VGG8B fuse_opt steps at scale 0.25 through the kernels ≡ the
    split steps on the kernels, and the fused apply ≡ the split apply."""
    cfg = get_paper_config("vgg8b", scale=0.25)
    rng = np.random.default_rng(11)
    fused = split = les.create_train_state(prng.PRNGKey(3), cfg, device=cuda_device)
    for it in range(2):
        x = torch.from_numpy(rng.integers(-127, 128, (16, *cfg.input_shape))
                             .astype(np.int32)).to(cuda_device)
        y = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32)).to(cuda_device)
        fused, fm = les.train_step(fused, cfg, x, y, prng.PRNGKey(it), fuse_opt=True)
        grads, sm, _ = les.compute_gradients(split, cfg, x, y, prng.PRNGKey(it))
        applied = les.apply_gradients(split, grads, fuse_opt=True)
        split = les.apply_gradients(split, grads)
        for f in ("loss", "correct", "local_losses"):
            assert torch.equal(getattr(fm, f), getattr(sm, f))
        for state in (fused, applied):
            for bs, bw in zip(state.params["blocks"], split.params["blocks"]):
                for part in ("fw", "lr"):
                    assert torch.equal(bs[part]["w"], bw[part]["w"])
            assert torch.equal(state.params["output"]["w"], split.params["output"]["w"])


#: (B, M, N) of #5's digit-variant cases: ragged (N = 3: 4-byte copies of
#: w; B of 1, 33 and 1,000), VGG8B's linear, a contraction of 40,000 (three
#: splits or more) and more splits than tiles (B = 1, M = 10)
_GRAD_X_MM = [(5, 7, 3), (33, 300, 70), (64, 2048, 1024), (1000, 20, 10), (3, 70, 40000),
              (1, 10, 20000)]
#: (N, H, W, C, F, K) of #10's: F = 12 (the masked patch planes), 32 with
#: odd W, 64 with C = 3 and K = 5, and K²F = 18,432 (the GEMM folds once)
_GRAD_X_CONV = [(2, 7, 9, 5, 12, 3), (2, 6, 5, 16, 32, 3), (1, 9, 7, 3, 64, 5),
                (1, 4, 5, 8, 2048, 3)]


@pytest.mark.gpu
def test_nitro_matmul_grad_x_matches_plain(cuda_device):
    """Full-range int32 δ and w (the sum wraps), ragged shapes, VGG8B's
    linear shape (a split fan-out) and α_inv 1, 2, 10; then every digit
    path — masked δ and w of one to four digits, 16 variants — at every
    shape of _GRAD_X_MM, each call twice (the same bits), and w whose rows
    are not 16-byte aligned (its 4-byte copies)."""
    g = torch.Generator().manual_seed(12)
    for b, m, n in ((5, 7, 3), (33, 300, 70), (64, 2048, 1024), (1000, 20, 10)):
        delta = _wide(g, (b, n), 2 ** 31 - 1, cuda_device)
        z = _wide(g, (b, n), 300, cuda_device)
        w = _wide(g, (m, n), 2 ** 31 - 1, cuda_device)
        for alpha_inv in (1, 2, 10):
            got = nitro_matmul_grad_x(delta, z, w, alpha_inv=alpha_inv)
            want = nitro_matmul_grad_x_ref(delta, z, w, alpha_inv=alpha_inv)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want)
    for b, m, n in _GRAD_X_MM:
        for d_lim in _LIMS:
            for w_lim in _LIMS:
                _, delta, z = _grad_w_operands(g, b, 1, n, 1, d_lim, cuda_device)
                w = _lim_ints(g, (m, n), w_lim, cuda_device)
                want = nitro_matmul_grad_x_ref(delta, z, w, alpha_inv=10)
                for _ in range(2):
                    got = nitro_matmul_grad_x(delta, z, w, alpha_inv=10)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype and torch.equal(got, want), \
                        (b, m, n, d_lim, w_lim)
        buf = _wide(g, (m * n + 1,), 2 ** 31 - 1, cuda_device)
        w = buf[1:].view(m, n)  # rows 4 bytes off 16-byte alignment
        got = nitro_matmul_grad_x(delta, z, w, alpha_inv=3)
        want = nitro_matmul_grad_x_ref(delta, z, w, alpha_inv=3)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, m, n, "w misaligned")


@pytest.mark.gpu
def test_stream_conv_grad_x_matches_plain(cuda_device):
    """The masked kernel (#10) and the unmasked route through stream_conv
    at sf=1, on full-range int32 δ, C = 3 and K = 5 among the shapes; then
    every digit path — masked δ and w of one to four digits, 16 variants —
    at every shape of _GRAD_X_CONV, each call twice (the same bits)."""
    g = torch.Generator().manual_seed(13)
    for n, h, w_sp, c, f, k, _ in _CONV_TRAIN:
        delta = _wide(g, (n, h, w_sp, f), 2 ** 31 - 1, cuda_device)
        z = _wide(g, (n, h, w_sp, f), 300, cuda_device)
        w = _wide(g, (k, k, c, f), 2 ** 15, cuda_device)
        for alpha_inv in (1, 10):
            got = stream_conv_grad_x(delta, z, w, alpha_inv=alpha_inv)
            want = stream_conv_grad_x_ref(delta, w, z_star=z, alpha_inv=alpha_inv)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want)
        got = conv_grad_x(delta, w, backend="cuda")
        want = stream_conv_grad_x_ref(delta, w)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)
    for n, h, w_sp, c, f, k in _GRAD_X_CONV:
        for d_lim in _LIMS:
            for w_lim in _LIMS:
                delta = _lim_ints(g, (n, h, w_sp, f), d_lim, cuda_device)
                z = _wide(g, (n, h, w_sp, f), 300, cuda_device)
                z.view(-1)[:2] = 0  # the mask keeps the planted extremes
                w = _lim_ints(g, (k, k, c, f), w_lim, cuda_device)
                want = stream_conv_grad_x_ref(delta, w, z_star=z, alpha_inv=10)
                for _ in range(2):
                    got = stream_conv_grad_x(delta, z, w, alpha_inv=10)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype and torch.equal(got, want), \
                        (n, h, w_sp, c, f, k, d_lim, w_lim)


#: int_matmul's routes: (route the rule gives, a, b) builders on the card
_ROUTE_CASES = {
    "T": lambda g, d: (_wide(g, (64, 10), 2 ** 31 - 1, d), _wide(g, (3000, 10), 2 ** 31 - 1, d).T),
    "W": lambda g, d: (_ints(g, (300, 1040), torch.int8, d),
                       _ints(g, (520, 1040), torch.int8, d).t()),
    "WT": lambda g, d: (_ints(g, (600, 1040), torch.int8, d), _ints(g, (1040, 77), torch.int8, d)),
    "D": lambda g, d: (_wide(g, (300, 1000), 2 ** 31 - 1, d), _wide(g, (1000, 200), 2 ** 31 - 1, d)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(_ROUTE_CASES))
def test_int_matmul_routes_match_plain(cuda_device, route):
    """int_matmul on each route (T: a thin product on a transposed view; W:
    int8 with a K-major b; W after the transpose pass: an N-major b; D:
    wide int32) ≡ int_matmul_ref, bitwise, twice, one launch counted on
    the route the rule gives."""
    from repro_torch.core.numerics import int_matmul_ref
    from repro_torch.kernels.int_matmul import int_matmul_cuda, plan

    a, b = _ROUTE_CASES[route](torch.Generator().manual_seed(27), cuda_device)
    assert plan(tuple(a.shape), a.dtype, a.stride(), a.data_ptr(),
                tuple(b.shape), b.dtype, b.stride(), b.data_ptr()) == route
    want = int_matmul_ref(a, b)
    counter = int_matmul_cuda.routes["W" if route == "WT" else route]
    for _ in range(2):
        before = counter.value
        got = int_matmul_cuda(a, b)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert counter.value == before + 1


@pytest.mark.gpu
def test_each_cuda_wrapper_call_records_one_kernel_span(cuda_device):
    """With a tracer installed, each call of a CUDA wrapper records one
    ``kernel.<entry>`` span (``int_matmul``'s with its route), and the
    spans number as many as the wrapper's launch counter adds."""
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.obs import trace
    from repro_torch.obs.trace import Tracer

    g = torch.Generator().manual_seed(32)

    def ints(*shape):
        return torch.randint(-60, 61, shape, generator=g, dtype=torch.int32).to(cuda_device)

    x, w, d, z = ints(4, 8, 8, 16), ints(3, 3, 16, 32), ints(4, 8, 8, 32), ints(4, 8, 8, 32)
    gw, gp = ints(3, 3, 16, 32), ints(4, 4, 4, 16)
    xl, wl, dl, zl = ints(32, 64), ints(64, 48), ints(32, 48), ints(32, 48)
    calls = {
        "stream_conv": (stream_conv, lambda: stream_conv(x, w, sf=512)),
        "stream_conv_fwd": (stream_conv_fwd, lambda: stream_conv_fwd(x, w, sf=512)),
        "stream_conv_grad_w": (stream_conv_grad_w, lambda: stream_conv_grad_w(
            x, d, kernel_size=3, z_star=z)),
        "stream_conv_grad_w_opt": (stream_conv_grad_w_opt, lambda: stream_conv_grad_w_opt(
            x, d, z, w, 512, 0, kernel_size=3)),
        "stream_conv_grad_x": (stream_conv_grad_x, lambda: stream_conv_grad_x(d, z, w)),
        "nitro_matmul": (nitro_matmul, lambda: nitro_matmul(xl, wl, sf=512)),
        "nitro_matmul_fwd": (nitro_matmul_fwd, lambda: nitro_matmul_fwd(xl, wl, sf=512)),
        "nitro_matmul_grad_w": (nitro_matmul_grad_w, lambda: nitro_matmul_grad_w(xl, dl, zl)),
        "nitro_matmul_grad_w_opt": (nitro_matmul_grad_w_opt, lambda: nitro_matmul_grad_w_opt(
            xl, dl, zl, wl, 512, 0)),
        "nitro_matmul_grad_x": (nitro_matmul_grad_x, lambda: nitro_matmul_grad_x(dl, zl, wl)),
        "integer_sgd_update": (integer_sgd_update, lambda: integer_sgd_update(w, gw, 512, 0)),
        "maxpool_fwd": (maxpool_fwd_cuda, lambda: maxpool_fwd_cuda(d)),
        "maxpool_bwd": (maxpool_bwd_cuda, lambda: maxpool_bwd_cuda(
            gp, gp.abs().remainder(4).to(torch.uint8), (4, 8, 8, 16))),
        "int_matmul": (int_matmul_cuda, lambda: int_matmul_cuda(xl, wl)),  # last: route
    }
    for entry, (fn, call) in calls.items():
        tracer = Tracer()
        before = fn.launches.value
        with trace.use(tracer):
            call()
            call()
        torch.cuda.synchronize()
        spans = [s for s in tracer.snapshot() if s.name.startswith("kernel.")]
        assert [s.name for s in spans] == [f"kernel.{entry}"] * 2, entry
        assert fn.launches.value - before == len(spans), entry
    assert spans[0].attrs["route"] in ("T", "W", "D")


#: (N, H, W, C, value range) of the pool kernels' cases: VGG8B's and
#: VGG11B's four pool inputs at batch 512 with ties (values in [-3, 3)) and
#: over the full int32 range, odd H and W with ties, C % 4 != 0 (the
#: one-channel variant) and a 1-wide odd edge
_POOL_CASES = [(512, 32, 32, 256, 3), (512, 16, 16, 512, 3), (512, 8, 8, 512, 3),
               (512, 4, 4, 512, 3), (512, 32, 32, 256, 2 ** 31), (512, 4, 4, 512, 2 ** 31),
               (7, 13, 11, 20, 3), (5, 9, 6, 6, 3), (3, 6, 7, 3, 2 ** 31), (2, 1, 5, 8, 3)]


@pytest.mark.gpu
def test_maxpool_kernels_match_plain(cuda_device):
    """``maxpool_fwd_cuda`` ≡ ``maxpool_fwd_ref`` (out and the first max's
    position) and ``maxpool_bwd_cuda`` ≡ ``maxpool_bwd_ref`` (δ of the input's
    shape, the cropped edge zero), one launch a call with work; a misaligned view takes
    the one-channel variant and gives the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(33)

    def ints(shape, lim):
        return torch.randint(-lim, lim, shape, generator=g, dtype=torch.int64,
                             device=cuda_device).to(torch.int32)

    for n, h, w_sp, c, lim in _POOL_CASES:
        shape = (n, h, w_sp, c)
        a = ints(shape, lim)
        before = (maxpool_fwd_cuda.launches.value, maxpool_bwd_cuda.launches.value)
        out, idx = maxpool_fwd_cuda(a)
        want_out, want_idx = maxpool_fwd_ref(a)
        torch.cuda.synchronize()
        assert out.dtype == torch.int32 and idx.dtype == torch.uint8, shape
        assert torch.equal(out, want_out) and torch.equal(idx, want_idx), shape
        grad = ints(tuple(out.shape), 2 ** 31)
        # a δ buffer of garbage first: the kernel writes every element itself
        torch.full(shape, 7, dtype=torch.int32, device=cuda_device)
        got = maxpool_bwd_cuda(grad, idx, shape)
        want = maxpool_bwd_ref(grad, want_idx, shape)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), shape
        assert (maxpool_fwd_cuda.launches.value - before[0],  # none for an empty out
                maxpool_bwd_cuda.launches.value - before[1]) == (int(h > 1), 1), shape
    view = ints((2 * 8 * 8 * 8 + 1,), 3)[1:].view(2, 8, 8, 8)  # 4 bytes off alignment
    out, idx = maxpool_fwd_cuda(view)
    want_out, want_idx = maxpool_fwd_ref(view)
    gview = ints((2 * 4 * 4 * 8 + 1,), 99)[1:].view(2, 4, 4, 8)
    got = maxpool_bwd_cuda(gview, want_idx, (2, 8, 8, 8))
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(idx, want_idx)
    assert torch.equal(got, maxpool_bwd_ref(gview, want_idx, (2, 8, 8, 8)))


@pytest.mark.gpu
def test_cuda_fuse_opt_step_pools_in_the_kernels(cuda_device):
    """A VGG8B fuse_opt step on the card launches each pool kernel once a
    pooled block (4) and runs no cumsum but the correct count's over the
    (B, 10) logits: the one-hot chain's int64 scan is gone."""
    cfg = get_paper_config("vgg8b", scale=0.25)
    rng = np.random.default_rng(12)
    state = les.create_train_state(prng.PRNGKey(4), cfg, device=cuda_device)
    x = torch.from_numpy(rng.integers(-127, 128, (16, *cfg.input_shape))
                         .astype(np.int32)).to(cuda_device)
    y = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32)).to(cuda_device)
    les.train_step(state, cfg, x, y, prng.PRNGKey(0), fuse_opt=True)  # builds, warms up
    torch.cuda.synchronize()
    before = (maxpool_fwd_cuda.launches.value, maxpool_bwd_cuda.launches.value)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        les.train_step(state, cfg, x, y, prng.PRNGKey(1), fuse_opt=True)
        torch.cuda.synchronize()
    assert (maxpool_fwd_cuda.launches.value - before[0],
            maxpool_bwd_cuda.launches.value - before[1]) == (4, 4)
    cumsums = [e.input_shapes[0] for e in prof.events() if e.name == "aten::cumsum"]
    assert cumsums == [[16, 10]], cumsums
