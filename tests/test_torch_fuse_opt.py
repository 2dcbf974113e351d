"""PyTorch port, ``fuse_opt`` slice: the fused IntegerSGD update ≡ the JAX
package's, bitwise, on the CPU.

Covers the plain versions of the three update kernels (``integer_sgd``,
``nitro_matmul_grad_w_opt``, ``stream_conv_grad_w_opt``) against the
JAX oracles and the Pallas kernels in interpret mode, the dispatchers and
the ``grad_ops``/``layers`` update functions with their escape hatches,
``train_step(fuse_opt=True)`` and ``apply_gradients(fuse_opt=True)``
trajectories against the JAX package's, and the trainer's
``--fuse-opt``.  The same numpy inputs and threefry keys go through both
sides; tolerance zero, dtype included.  The CUDA kernels themselves run
only on a card: ``tests/test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import paper as jpaper
from repro.core import layers as jlayers
from repro.core import les as jles
from repro.core import optimizer as jopt
from repro.kernels.integer_sgd import integer_sgd_ref as j_integer_sgd_ref
from repro.kernels.integer_sgd import integer_sgd_update as j_integer_sgd_update
from repro.kernels.nitro_conv import ops as jconv_ops
from repro.kernels.nitro_conv.nitro_conv import (
    stream_conv_grad_w_opt as j_stream_conv_grad_w_opt,
)
from repro.kernels.nitro_matmul import ops as jmm_ops
from repro.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul_grad_w_opt as j_nitro_matmul_grad_w_opt,
)
from repro.launch import train as jtrain
from repro_torch.configs import paper as tpaper
from repro_torch.core import layers as tlayers
from repro_torch.core import les as tles
from repro_torch.core import optimizer as topt
from repro_torch.core import prng
from repro_torch.kernels.integer_sgd import apply_tree_fused
from repro_torch.kernels.integer_sgd import integer_sgd_ref as t_integer_sgd_ref
from repro_torch.kernels.integer_sgd import integer_sgd_update as t_integer_sgd_update
from repro_torch.kernels.nitro_conv import ops as tconv_ops
from repro_torch.kernels.nitro_conv import ref as tconv_ref
from repro_torch.kernels.nitro_conv.nitro_conv import (
    stream_conv_grad_w_opt as t_stream_conv_grad_w_opt,
)
from repro_torch.kernels.nitro_matmul import ops as tmm_ops
from repro_torch.kernels.nitro_matmul import ref as tmm_ref
from repro_torch.kernels.nitro_matmul.nitro_matmul import (
    nitro_matmul_grad_w_opt as t_nitro_matmul_grad_w_opt,
)
from repro_torch.launch import train as ttrain

I32 = (-(2 ** 31), 2 ** 31 - 1)


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


# (γ_inv, η_inv): the paper's lr/decay, decay off, γ_inv = 1, the forward
# layers' AF-amplified γ after two plateaus (×9), and a γ_inv so large that
# every floor of a small gradient is 0 or −1
STATES = [(512, 12000), (512, 0), (1, 0), (1, 3), (512 * 640 * 9, 30000),
          (2 ** 30 + 7, 5)]


# ---------------------------------------------------------------------------
# Kernel 11: integer_sgd_update
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(
    w=st.lists(st.integers(*I32), min_size=1, max_size=40),
    g_seed=st.integers(0, 2 ** 16),
    gamma=st.one_of(st.just(1), st.integers(1, I32[1]), st.integers(I32[0], -1)),
    eta=st.one_of(st.just(0), st.integers(1, 70000), st.integers(*I32)),
)
@example(w=[I32[0], I32[1], -1, 0, 1, -7, 7], g_seed=0, gamma=1, eta=0)
@example(w=[I32[0], -5, -3, -1, 0, 2, 3], g_seed=1, gamma=1, eta=3)
@example(w=[I32[0], I32[1], -100], g_seed=2, gamma=-1, eta=I32[0])
def test_integer_sgd_ref_matches_jax(w, g_seed, gamma, eta):
    """W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋) on full-range int32: floor for negative
    W and g (and γ_inv), η_inv = 0 for no decay, η_inv < 0 read as 1, and
    the sum and difference wrapping mod 2³²."""
    w = np.array(w, np.int32)
    rng = np.random.default_rng(g_seed)
    g = np.concatenate([np.array([I32[0], I32[1], -1, 1, 0], np.int32),
                        _ints(rng, (len(w) + 3,), *I32)])[: len(w)]
    got = t_integer_sgd_ref(_t(w), _t(g), gamma, eta)
    _eq(got, j_integer_sgd_ref(jnp.asarray(w), jnp.asarray(g), gamma, eta))
    state = topt.init_state(gamma, eta)
    assert torch.equal(apply_tree_fused({"w": _t(w)}, {"w": _t(g)}, state)["w"], got)


def test_integer_sgd_decay_asymmetry():
    """At zero gradient a weight in [−η_inv, 0) climbs by one, one in
    [0, η_inv) stays: Algorithm 1's floor, as the JAX optimiser has it."""
    w = np.arange(-6, 7, dtype=np.int32)
    got = t_integer_sgd_ref(_t(w), torch.zeros(13, dtype=torch.int32), 512, 6)
    _eq(got, j_integer_sgd_ref(jnp.asarray(w), jnp.zeros(13, jnp.int32), 512, 6))
    assert got.tolist() == [-5, -4, -3, -2, -1, 0, 0, 1, 2, 3, 4, 5, 5]


@pytest.mark.parametrize("shape", [(7,), (3, 5), (129,), (8, 128), (130, 3), (3, 3, 4, 5)])
@pytest.mark.parametrize("gamma,eta", STATES)
def test_integer_sgd_plain_matches_pallas(shape, gamma, eta):
    rng = np.random.default_rng(sum(shape) + gamma % 97 + eta)
    w, g = _ints(rng, shape, -9000, 9000), _ints(rng, shape, -(2 ** 24), 2 ** 24)
    j_gamma, j_eta = jnp.int32(gamma), jnp.int32(eta)
    _eq(t_integer_sgd_ref(_t(w), _t(g), gamma, eta),
        j_integer_sgd_update(jnp.asarray(w), jnp.asarray(g), j_gamma, j_eta,
                             interpret=True),
        j_integer_sgd_ref(jnp.asarray(w), jnp.asarray(g), gamma, eta))


def test_apply_tree_fused_checks_leaves_and_backend():
    state = topt.init_state(512, 3000)
    w = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="integer_sgd weight"):
        apply_tree_fused({"w": w.float()}, {"w": w}, state)
    with pytest.raises(TypeError, match="integer_sgd gradient"):
        apply_tree_fused({"w": w}, {"w": w.double()}, state)
    with pytest.raises(ValueError, match="unknown backend"):
        apply_tree_fused({"w": w}, {"w": w}, state, backend="pallas")
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA tensors"):
        apply_tree_fused({"w": w}, {"w": w}, state, backend="cuda")


# ---------------------------------------------------------------------------
# Kernels 4 and 9: the grad_W kernels with IntegerSGD in the flush
# ---------------------------------------------------------------------------


def _linear_case(b, m, n, seed, wide=False):
    rng = np.random.default_rng(seed)
    x = _ints(rng, (b, m), *I32) if wide else _ints(rng, (b, m), -127, 128)
    delta = _ints(rng, (b, n), *I32) if wide else _ints(rng, (b, n), -(2 ** 16), 2 ** 16)
    z = _ints(rng, (b, n), -300, 301)
    w = _ints(rng, (m, n), *I32) if wide else _ints(rng, (m, n), -(2 ** 15), 2 ** 15)
    return x, delta, z, w


def _conv_case(n, h, w_sp, c, f, k, seed, wide=False):
    rng = np.random.default_rng(seed)
    x = _ints(rng, (n, h, w_sp, c), -127, 128)
    delta = (_ints(rng, (n, h, w_sp, f), *I32) if wide
             else _ints(rng, (n, h, w_sp, f), -(2 ** 16), 2 ** 16))
    z = _ints(rng, (n, h, w_sp, f), -300, 301)
    w = (_ints(rng, (k, k, c, f), *I32) if wide
         else _ints(rng, (k, k, c, f), -(2 ** 15), 2 ** 15))
    return x, delta, z, w


@pytest.mark.parametrize("shape,wide", [((5, 7, 3), False), ((12, 40, 24), False),
                                        ((9, 130, 70), False), ((40, 33, 70), True)])
@pytest.mark.parametrize("gamma,eta", STATES[:4])
@pytest.mark.parametrize("alpha_inv", [1, 10])
def test_matmul_grad_w_opt_matches_jax(shape, wide, gamma, eta, alpha_inv):
    """Plain version and dispatcher ≡ the Pallas kernel (interpret) ≡ the
    JAX dispatcher's reference, on ragged shapes and wrapping operands."""
    x, delta, z, w = _linear_case(*shape, seed=sum(shape) + alpha_inv, wide=wide)
    targs = [_t(a) for a in (x, delta, z, w)]
    jargs = [jnp.asarray(a) for a in (x, delta, z, w)]
    got = tmm_ref.nitro_matmul_grad_w_opt_ref(*targs, gamma, eta, alpha_inv=alpha_inv)
    _eq(got,
        j_nitro_matmul_grad_w_opt(*jargs, jnp.int32(gamma), jnp.int32(eta),
                                  alpha_inv=alpha_inv, interpret=True),
        jmm_ops.grad_w_opt_matmul(*jargs, gamma, eta, alpha_inv=alpha_inv,
                                  backend="reference"))
    state = topt.init_state(gamma, eta)
    disp = tmm_ops.grad_w_opt_matmul(*targs, state.gamma_inv, state.eta_inv,
                                     alpha_inv=alpha_inv)
    assert torch.equal(disp, got)


_CONV_OPT = [(2, 8, 6, 3, 8, 3), (2, 9, 7, 3, 5, 3), (1, 5, 7, 6, 10, 5), (3, 4, 4, 4, 9, 3)]


@pytest.mark.parametrize("n,h,w_sp,c,f,k", _CONV_OPT)
@pytest.mark.parametrize("gamma,eta", [STATES[0], STATES[2], STATES[4]])
@pytest.mark.parametrize("alpha_inv", [1, 10])
def test_conv_grad_w_opt_matches_jax(n, h, w_sp, c, f, k, gamma, eta, alpha_inv):
    wide = (n, h) == (3, 4)
    x, delta, z, w = _conv_case(n, h, w_sp, c, f, k, seed=h * w_sp + f, wide=wide)
    targs = [_t(a) for a in (x, delta, z, w)]
    jx, jd, jz, jw = (jnp.asarray(a) for a in (x, delta, z, w))
    got = tconv_ref.stream_conv_grad_w_opt_ref(*targs, gamma, eta, kernel_size=k,
                                               alpha_inv=alpha_inv)
    _eq(got,
        j_stream_conv_grad_w_opt(jx, jd, jz, jw, jnp.int32(gamma), jnp.int32(eta),
                                 kernel_size=k, alpha_inv=alpha_inv, interpret=True),
        jconv_ops.conv_grad_w_opt(jx, jd, jw, gamma, eta, kernel_size=k, z_star=jz,
                                  alpha_inv=alpha_inv, backend="reference"))
    tx, td, tz, tw = targs
    disp = tconv_ops.conv_grad_w_opt(tx, td, tw, gamma, eta, kernel_size=k, z_star=tz,
                                     alpha_inv=alpha_inv)
    assert torch.equal(disp, got)


def test_conv_grad_w_opt_rejects_materialise_as_jax_does():
    x, delta, z, w = _conv_case(1, 4, 4, 2, 4, 3, seed=6)
    for ops, arr in ((tconv_ops, _t), (jconv_ops, jnp.asarray)):
        with pytest.raises(ValueError, match="stream-only"):
            ops.conv_grad_w_opt(arr(x), arr(delta), arr(w), 512, 0, kernel_size=3,
                                z_star=arr(z), conv_mode="materialise")


# ---------------------------------------------------------------------------
# grad_ops / layers: the update functions and their escape hatches
# ---------------------------------------------------------------------------


def _states(gamma, eta):
    return topt.init_state(gamma, eta), jopt.init_state(gamma, eta)


@pytest.mark.parametrize("hatch", ["fused", "unfused-bwd", "no-z"])
def test_linear_update_matches_jax(hatch):
    x, delta, z, w = _linear_case(8, 32, 16, seed=3)
    ts, js = _states(512, 12000)
    kw = {"fused": {}, "unfused-bwd": {"fuse_bwd": False}, "no-z": {}}[hatch]
    tz = None if hatch == "no-z" else _t(z)
    jz = None if hatch == "no-z" else jnp.asarray(z)
    gx, new = tlayers.linear_update({"w": _t(w)}, _t(x), _t(delta), ts,
                                    z_star=tz, alpha_inv=3, **kw)
    jgx, jnew = jlayers.linear_update({"w": jnp.asarray(w)}, jnp.asarray(x),
                                      jnp.asarray(delta), js, z_star=jz, alpha_inv=3,
                                      backend="reference", **kw)
    _eq(new["w"], jnew["w"])
    _eq(gx, jgx)  # grad_x on every route, the fused one through grad_x_matmul
    # every route is bitwise backward-then-apply_update
    _, grads = tlayers.linear_backward({"w": _t(w)}, _t(x), _t(delta), z_star=tz,
                                       alpha_inv=3)
    assert torch.equal(new["w"], topt.apply_update(_t(w), grads["w"], ts))


@pytest.mark.parametrize("hatch", ["fused", "unfused-bwd", "no-z"])
def test_conv_update_matches_jax(hatch):
    x, delta, z, w = _conv_case(2, 8, 6, 3, 8, 3, seed=7)
    ts, js = _states(3, 7)
    kw = {"fused": {}, "unfused-bwd": {"fuse_bwd": False}, "no-z": {}}[hatch]
    tz = None if hatch == "no-z" else _t(z)
    jz = None if hatch == "no-z" else jnp.asarray(z)
    gx, new = tlayers.conv_update({"w": _t(w)}, tlayers.ConvCache(x=_t(x)), _t(delta),
                                  ts, z_star=tz, **kw)
    jgx, jnew = jlayers.conv_update({"w": jnp.asarray(w)}, jlayers.ConvCache(x=jnp.asarray(x)),
                                    jnp.asarray(delta), js, z_star=jz,
                                    backend="reference", **kw)
    _eq(gx, jgx)
    _eq(new["w"], jnew["w"])


def test_conv_update_materialise_is_not_ported_for_training():
    """JAX's materialise hatch goes through the materialised conv
    gradients, which the port now trains with (it raised before they were
    ported): (grad_x, W′) equal JAX's."""
    x, delta, z, w = _conv_case(1, 4, 4, 2, 4, 3, seed=8)
    ts, js = _states(512, 0)
    gx, new = tlayers.conv_update({"w": _t(w)}, tlayers.ConvCache(x=_t(x)), _t(delta), ts,
                                  z_star=_t(z), conv_mode="materialise")
    jgx, jnew = jlayers.conv_update({"w": jnp.asarray(w)}, jlayers.ConvCache(x=jnp.asarray(x)),
                                    jnp.asarray(delta), js, z_star=jnp.asarray(z),
                                    conv_mode="materialise", backend="reference")
    _eq(gx, jgx)
    _eq(new["w"], jnew["w"])


def test_update_kernels_no_cpu_fallback():
    """CPU tensors never reach a kernel: the wrappers and backend='cuda'
    raise, and no launch is counted."""
    x, delta, z, w = (_t(a) for a in _linear_case(4, 6, 5, seed=9))
    cx, cd, cz, cw = (_t(a) for a in _conv_case(2, 4, 4, 3, 5, 3, seed=9))
    on_card = "on one CUDA device"
    with pytest.raises(ValueError, match=on_card):
        t_nitro_matmul_grad_w_opt(x, delta, z, w, 512, 0)
    with pytest.raises(ValueError, match=on_card):
        t_stream_conv_grad_w_opt(cx, cd, cz, cw, 512, 0, kernel_size=3)
    with pytest.raises(ValueError, match=on_card):
        t_integer_sgd_update(w, w, 512, 0)
    cuda_only = "backend='cuda' needs CUDA tensors"
    with pytest.raises(ValueError, match=cuda_only):
        tmm_ops.grad_w_opt_matmul(x, delta, z, w, 512, 0, backend="cuda")
    with pytest.raises(ValueError, match=cuda_only):
        tconv_ops.conv_grad_w_opt(cx, cd, cw, 512, 0, kernel_size=3, z_star=cz,
                                  backend="cuda")
    with pytest.raises(ValueError, match=r"w \(6, 4\) != \(6, 5\)"):
        t_nitro_matmul_grad_w_opt(x, delta, z, w[:, :4], 512, 0)
    for fn in (t_nitro_matmul_grad_w_opt, t_stream_conv_grad_w_opt, t_integer_sgd_update):
        assert fn.launches.value == 0


# ---------------------------------------------------------------------------
# The slice: train_step(fuse_opt=True), apply_gradients(fuse_opt=True), CLI
# ---------------------------------------------------------------------------

SCALE = 0.0625
BATCH = 4


def _batch(cfg, it, seed=0):
    rng = np.random.default_rng(seed * 100 + it)
    x = rng.integers(-127, 128, (BATCH, *cfg.input_shape)).astype(np.int32)
    y = rng.integers(0, cfg.num_classes, BATCH).astype(np.int32)
    return x, y


def _leaves(params) -> list:
    return ([b[k]["w"] for b in params["blocks"] for k in ("fw", "lr")]
            + [params["output"]["w"]])


def _assert_state_eq(ts, js) -> None:
    for a, b in zip(_leaves(ts.params), _leaves(js.params), strict=True):
        _eq(a, b)
    for grp in ("opt_lr", "opt_fw"):
        for f in ("gamma_inv", "eta_inv"):
            _eq(getattr(getattr(ts, grp), f), getattr(getattr(js, grp), f))
    _eq(ts.step, js.step)


def _assert_metrics_eq(tm, jm) -> None:
    for f in ("loss", "correct", "local_losses"):
        _eq(getattr(tm, f), getattr(jm, f))


def _train_states(arch, seed=0):
    tcfg, jcfg = tpaper.get(arch, scale=SCALE), jpaper.get(arch, scale=SCALE)
    ts = tles.create_train_state(prng.PRNGKey(seed), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(seed), jcfg)
    return tcfg, jcfg, ts, js


@pytest.mark.parametrize("arch", ["vgg8b", "vgg11b"])
def test_fuse_opt_trajectory_matches_jax(arch):
    """Three fuse_opt steps from the same key ≡ JAX's fuse_opt trajectory,
    and ≡ the port's own split step; a plateau between steps 1 and 2
    triples γ_inv on both sides."""
    tcfg, jcfg, ts, js = _train_states(arch)
    us = ts
    jstep = jax.jit(functools.partial(jles.train_step, cfg=jcfg, fuse_opt=True,
                                      backend="reference"))
    for it in range(3):
        if it == 2:
            ts, us = tles.reduce_lr_on_plateau(ts, True), tles.reduce_lr_on_plateau(us, True)
            js = jles.reduce_lr_on_plateau(js, True)
        x, y = _batch(tcfg, it)
        ts, tm = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(it), fuse_opt=True)
        us, um = tles.train_step(us, tcfg, _t(x), _t(y), prng.PRNGKey(it))
        js, jm = jstep(js, x=jnp.asarray(x), labels=jnp.asarray(y),
                       key=jax.random.PRNGKey(it))
        _assert_metrics_eq(tm, jm)
        _assert_metrics_eq(tm, um)
        _assert_state_eq(ts, js)
    for a, b in zip(_leaves(ts.params), _leaves(us.params)):
        assert torch.equal(a, b)


def test_fuse_opt_step_matches_jax_interpret_kernels():
    """One vgg8b fuse_opt step against JAX's on its Pallas kernels
    (the *_grad_w_opt flushes included) in interpret mode, and with the
    unfused forward and δ mask."""
    tcfg, jcfg, ts, js = _train_states("vgg8b", seed=2)
    x, y = _batch(tcfg, 0, seed=2)
    t1, tm = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(7), fuse_opt=True,
                             backend="reference")
    j1, jm = jles.train_step(js, jcfg, jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(7), fuse_opt=True, backend="interpret")
    _assert_metrics_eq(tm, jm)
    _assert_state_eq(t1, j1)
    u1, _ = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(7), fuse_opt=True,
                            fused=False, fuse_bwd=False)
    for a, b in zip(_leaves(t1.params), _leaves(u1.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend,arch", [
    pytest.param("auto", "vgg8b", id="auto"),
    pytest.param("reference", "vgg8b", id="reference"),
    *(pytest.param(b, a, id=f"{b}-{a}") for a in ("vgg11b", "mlp1", "mlp2", "mlp3", "mlp4")
      for b in ("auto", "reference")),
])
def test_apply_gradients_fuse_opt_matches_jax(backend, arch):
    """The fused apply (every group's tensors through one apply_groups_fused
    call) ≡ JAX's apply_gradients(fuse_opt=True) on its Pallas kernel in
    interpret mode ≡ the port's split apply."""
    tcfg, jcfg, ts, js = _train_states(arch, seed=3)
    x, y = _batch(tcfg, 0, seed=3)
    tg, _, _ = tles.compute_gradients(ts, tcfg, _t(x), _t(y), prng.PRNGKey(2))
    jg, _, _ = jles.compute_gradients(js, jcfg, jnp.asarray(x), jnp.asarray(y),
                                      jax.random.PRNGKey(2), backend="reference")
    got = tles.apply_gradients(ts, tg, fuse_opt=True, backend=backend)
    want = jles.apply_gradients(js, jg, fuse_opt=True, backend="interpret")
    _assert_state_eq(got, want)
    split = tles.apply_gradients(ts, tg)
    for a, b in zip(_leaves(got.params), _leaves(split.params)):
        assert torch.equal(a, b)


def test_train_nitro_fuse_opt_matches_jax(capsys):
    """The trainer's --fuse-opt on the CPU: the JAX trainer's accuracy,
    scaled loss and progress lines, and the split run's final state."""
    got = ttrain.main(["--arch", "vgg8b", "--steps", "2", "--batch", "8",
                       "--scale", str(SCALE), "--device", "cpu", "--fuse-opt"])
    tout = capsys.readouterr().out
    want = jtrain.train_nitro("vgg8b", steps=2, batch=8, ckpt_dir=None,
                              dataset="tiles32", scale=SCALE, fuse_opt=True)
    jout = capsys.readouterr().out
    assert got["steps"] == want["steps"] == 2
    assert got["test_accuracy"] == want["test_accuracy"]
    assert got["scaled_loss"] == want["scaled_loss"]
    for line in ("step     0", "[done] test accuracy"):
        t_line = next(ln for ln in tout.splitlines() if ln.startswith(line))
        j_line = next(ln for ln in jout.splitlines() if ln.startswith(line))
        assert t_line == j_line
    split = ttrain.train_nitro("vgg8b", steps=2, batch=8, scale=SCALE, device="cpu")
    for a, b in zip(_leaves(got["state"].params), _leaves(split["state"].params)):
        assert torch.equal(a, b)
