"""PyTorch port on a CUDA card: each kernel ≡ its plain version, bitwise.

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
from repro_torch.infer import compile_plan, freeze
from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv
from repro_torch.kernels.nitro_conv.ref import stream_conv_ref
from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul
from repro_torch.kernels.nitro_matmul.ref import nitro_matmul_ref

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


@pytest.mark.gpu
def test_stream_conv_matches_plain(cuda_device):
    g = torch.Generator().manual_seed(1)
    for n, h, w_sp, c, f, k, pool, od, bh, sf in _CONV_CASES:
        x = _ints(g, (n, h, w_sp, c), _T[od], cuda_device)
        w = _ints(g, (k, k, c, f), _T[od], cuda_device)
        kw = dict(sf=sf, pool=pool, out_dtype=torch.int8, operand_dtype=od, bh=bh)
        got = stream_conv(x, w, **kw)
        want = stream_conv_ref(x, w, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_plan_matches_reference_plan(cuda_device):
    cfg = get_paper_config("vgg8b", scale=0.25)
    fm = freeze(M.init_params(torch.Generator().manual_seed(2), cfg, device="cpu"), cfg)
    x = np.random.default_rng(2).integers(-127, 128, (5, *cfg.input_shape)).astype(np.int32)
    got = compile_plan(fm, device=cuda_device).logits(x)
    want = compile_plan(fm, device=cuda_device, backend="reference").logits(x)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(compile_plan(fm, device="cpu").logits(x), want.cpu())
