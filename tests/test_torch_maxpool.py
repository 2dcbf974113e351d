"""PyTorch port, training max-pool (``repro_torch.kernels.maxpool``) on the
CPU: the dispatchers' plain versions ≡ the JAX package's
``layers.maxpool_forward`` / ``maxpool_backward`` bitwise (``idx`` is the
JAX one-hot's position), and the fused block path that takes them ≡ the
unfused one-hot composition.  The CUDA kernels are held against the plain
versions in ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as jlayers
from repro_torch.configs import paper as tpaper
from repro_torch.core import blocks as B
from repro_torch.core import layers as tlayers
from repro_torch.core import les, prng
from repro_torch.kernels.maxpool import (
    maxpool_bwd,
    maxpool_bwd_cuda,
    maxpool_fwd,
    maxpool_fwd_cuda,
)
from repro_torch.obs import trace
from repro_torch.obs.trace import Tracer

#: (N, H, W, C): odd H, odd W, both, a 1-wide edge, C of 1, 3, 4 and 8
_SHAPES = [(2, 6, 8, 1), (3, 7, 5, 3), (2, 4, 9, 4), (1, 5, 5, 8), (2, 3, 2, 4), (1, 2, 2, 1),
           (2, 1, 3, 4), (4, 8, 8, 8)]


def _eq(t, j) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    assert got.shape == j.shape, (got.shape, j.shape)
    assert np.array_equal(got, j)


def _ties(shape, seed):
    """Values in [-3, 3): most windows hold a tie for their max."""
    return np.random.default_rng(seed).integers(-3, 3, shape).astype(np.int32)


@pytest.mark.parametrize("shape", _SHAPES)
def test_plain_forward_matches_jax(shape):
    x = _ties(shape, sum(shape))
    out, idx = maxpool_fwd(torch.from_numpy(x))
    jout, jc = jlayers.maxpool_forward(jnp.asarray(x))
    _eq(out, jout)
    assert idx.dtype == torch.uint8 and tuple(idx.shape) == tuple(out.shape)
    _eq(idx.to(torch.int32), np.argmax(np.asarray(jc.onehot), axis=3).astype(np.int32))


@pytest.mark.parametrize("shape", _SHAPES)
def test_plain_backward_matches_jax(shape):
    x = _ties(shape, 7 * sum(shape))
    out, idx = maxpool_fwd(torch.from_numpy(x))
    _, jc = jlayers.maxpool_forward(jnp.asarray(x))
    rng = np.random.default_rng(len(shape) + sum(shape))
    g = rng.integers(-2 ** 31, 2 ** 31, tuple(out.shape), dtype=np.int64).astype(np.int32)
    got = maxpool_bwd(torch.from_numpy(g), idx, shape)
    _eq(got, jlayers.maxpool_backward(jc, jnp.asarray(g)))


def test_plain_forward_lifts_narrow_input():
    """An int8 activation pools to the int32 output the kernel gives."""
    x = _ties((2, 4, 6, 3), 5)
    out, idx = maxpool_fwd(torch.from_numpy(x.astype(np.int8)))
    want, want_idx = maxpool_fwd(torch.from_numpy(x))
    assert out.dtype == torch.int32 and torch.equal(out, want) and torch.equal(idx, want_idx)


def test_dispatch_and_wrappers_refuse_what_they_cannot_run():
    a = torch.zeros((1, 4, 4, 4), dtype=torch.int32)
    idx = torch.zeros((1, 2, 2, 4), dtype=torch.uint8)
    g = torch.zeros((1, 2, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="backend='cuda'"):
        maxpool_fwd(a, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        maxpool_bwd(g, idx, (1, 4, 4, 4), backend="plain")
    with pytest.raises(ValueError, match="CUDA device"):
        maxpool_fwd_cuda(a)
    with pytest.raises(ValueError, match="must"):
        maxpool_bwd_cuda(g, idx, (1, 6, 4, 4))
    with pytest.raises(ValueError, match="uint8"):
        maxpool_bwd_cuda(g, idx.to(torch.int32), (1, 4, 4, 4))
    with pytest.raises(TypeError):
        maxpool_fwd(a.float())


@pytest.mark.parametrize("in_shape", [(3, 8, 8, 3), (2, 7, 9, 5)])
def test_fused_block_matches_unfused_composition(in_shape):
    """A pooled conv block: ``forward_layers(fused=True, backend="reference")``
    then ``forward_layers_delta`` ≡ the ``fused=False`` one-hot composition,
    activation, z* and δ bit for bit."""
    spec = B.BlockSpec("conv", 8, pool=True, d_lr=64)
    params, _ = B.init_block(prng.PRNGKey(3), spec, in_shape[1:], 10)
    x = torch.from_numpy(np.random.default_rng(9).integers(-127, 128, in_shape)
                         .astype(np.int32))
    fa, fc = B.forward_layers(params, spec, x, fused=True, backend="reference")
    ua, uc = B.forward_layers(params, spec, x, fused=False)
    assert isinstance(fc["pool"], B.PoolIndexCache) and isinstance(uc["pool"], tlayers.PoolCache)
    assert torch.equal(fa, ua) and torch.equal(fc["act"], uc["act"])
    assert torch.equal(fc["z_star"], uc["z_star"])
    delta = torch.from_numpy(np.random.default_rng(4).integers(
        -2 ** 20, 2 ** 20, tuple(fa.shape)).astype(np.int32))
    got = B.forward_layers_delta(fc, delta, backend="reference")
    want = B.forward_layers_delta(uc, delta)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("fuse_opt", [False, True])
def test_fused_step_pools_through_the_dispatcher(fuse_opt, monkeypatch):
    """A VGG8B step takes each pooled block's pool through ``dispatch.maxpool_*``
    (one of each a pooled block), never the one-hot chain, and lands where
    the ``fused=False`` step does."""
    cfg = tpaper.get("vgg8b", scale=0.0625)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-127, 128, (4, *cfg.input_shape)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, 4).astype(np.int32))
    state = les.create_train_state(prng.PRNGKey(5), cfg, device="cpu")
    want, wm = les.train_step(state, cfg, x, y, prng.PRNGKey(1), fused=False, fuse_opt=fuse_opt)

    def one_hot_chain(*_a, **_k):
        raise AssertionError("the fused step ran the one-hot pool")

    monkeypatch.setattr(tlayers, "maxpool_forward", one_hot_chain)
    monkeypatch.setattr(tlayers, "maxpool_backward", one_hot_chain)
    tracer = Tracer()
    with trace.use(tracer):
        got, gm = les.train_step(state, cfg, x, y, prng.PRNGKey(1), fuse_opt=fuse_opt)
    names = [s.name for s in tracer.snapshot()]
    pooled = sum(spec.pool for spec in cfg.blocks)
    assert pooled == 4
    assert names.count("dispatch.maxpool_fwd") == names.count("dispatch.maxpool_bwd") == pooled
    for f in ("loss", "correct", "local_losses"):
        assert torch.equal(getattr(gm, f), getattr(wm, f))
    for bg, bw in zip(got.params["blocks"], want.params["blocks"]):
        for part in ("fw", "lr"):
            assert torch.equal(bg[part]["w"], bw[part]["w"])
    assert torch.equal(got.params["output"]["w"], want.params["output"]["w"])
