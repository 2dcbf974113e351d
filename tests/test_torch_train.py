"""PyTorch port, training slice: ``repro_torch``'s LES training ≡ the JAX
package's, bitwise, on the CPU.

The same numpy inputs and the same threefry keys go through both; every
value is an integer, so results must be equal, dtype included.  The JAX
side runs its plain reference (``backend="reference"``) and, for one
step, its Pallas kernels in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import activations as jact
from repro.core import layers as jlayers
from repro.core import les as jles
from repro.core import losses as jlosses
from repro.core import optimizer as jopt
from repro.core import preprocessing as jpre
from repro.core import scaling as jscale
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro_torch.configs import paper as tpaper
from repro_torch.core import activations as tact
from repro_torch.core import layers as tlayers
from repro_torch.core import les as tles
from repro_torch.core import losses as tlosses
from repro_torch.core import optimizer as topt
from repro_torch.core import preprocessing as tpre
from repro_torch.core import prng
from repro_torch.core import scaling as tscale
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain


def _eq(t, j) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    assert got.shape == j.shape, (got.shape, j.shape)
    assert np.array_equal(got, j)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Activations, scaling, losses, optimiser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha_inv", [1, 2, 10])
def test_nitro_relu_backward(alpha_inv):
    rng = np.random.default_rng(alpha_inv)
    z = np.concatenate([np.arange(-300, 301), rng.integers(-2000, 2000, 500)]).astype(np.int32)
    g = rng.integers(-(2 ** 20), 2 ** 20, z.shape).astype(np.int32)
    _eq(tact.nitro_relu_backward(_t(z), _t(g), alpha_inv),
        jact.nitro_relu_backward(jnp.asarray(z), jnp.asarray(g), alpha_inv))
    _eq(tscale.scale_backward(_t(g)), jscale.scale_backward(jnp.asarray(g)))


def test_one_hot_and_rss():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    y_hat = rng.integers(-200, 200, (16, 10)).astype(np.int32)
    ty = tlosses.one_hot_int(_t(labels), 10)
    jy = jlosses.one_hot_int(jnp.asarray(labels), 10)
    _eq(ty, jy)
    _eq(tlosses.rss_loss(_t(y_hat), ty), jlosses.rss_loss(jnp.asarray(y_hat), jy))
    _eq(tlosses.rss_grad(_t(y_hat), ty), jlosses.rss_grad(jnp.asarray(y_hat), jy))
    # the int32 sum wraps as XLA's does
    big = np.full((4, 10), 40000, np.int32)
    _eq(tlosses.rss_loss(_t(big), ty[:4]), jlosses.rss_loss(jnp.asarray(big), jy[:4]))


@pytest.mark.parametrize("gamma,eta", [(512, 0), (512, 25000), (3, 7), (327680, 3000)])
def test_apply_update_incl_negative_weight_decay(gamma, eta):
    """Floor-division decay: small negative weights get the +1 nudge."""
    rng = np.random.default_rng(gamma + eta)
    w = np.concatenate([np.arange(-50, 51), rng.integers(-(2 ** 20), 2 ** 20, 400)]).astype(np.int32)
    g = rng.integers(-(2 ** 24), 2 ** 24, w.shape).astype(np.int32)
    ts, js = topt.init_state(gamma, eta), jopt.init_state(gamma, eta)
    _eq(ts.gamma_inv, js.gamma_inv)
    _eq(ts.eta_inv, js.eta_inv)
    _eq(topt.apply_update(_t(w), _t(g), ts), jopt.apply_update(jnp.asarray(w), jnp.asarray(g), js))
    zero = np.zeros_like(w)
    _eq(topt.apply_update(_t(w), _t(zero), ts),
        jopt.apply_update(jnp.asarray(w), jnp.asarray(zero), js))
    _eq(topt.apply_tree({"w": _t(w)}, {"w": _t(g)}, ts)["w"],
        jopt.apply_tree({"w": jnp.asarray(w)}, {"w": jnp.asarray(g)}, js)["w"])


def test_lr_schedule_and_amplification_factor():
    for g in (2, 10, 100):
        assert topt.amplification_factor(g) == jopt.amplification_factor(g)
    ts, js = topt.init_state(512, 3), jopt.init_state(512, 3)
    for plateau in (False, True, True):
        ts = topt.step_lr_schedule(ts, plateau)
        js = jopt.step_lr_schedule(js, plateau)
        _eq(ts.gamma_inv, js.gamma_inv)
        _eq(ts.eta_inv, js.eta_inv)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (3, 7, 5, 4), (1, 2, 2, 1)])
def test_maxpool_forward_backward_ties_first(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-3, 3, shape).astype(np.int32)  # many ties per window
    tout, tc = tlayers.maxpool_forward(_t(x))
    jout, jc = jlayers.maxpool_forward(jnp.asarray(x))
    _eq(tout, jout)
    _eq(tc.onehot, jc.onehot)
    g = rng.integers(-1000, 1000, tuple(tout.shape)).astype(np.int32)
    _eq(tlayers.maxpool_backward(tc, _t(g)), jlayers.maxpool_backward(jc, jnp.asarray(g)))


@pytest.mark.parametrize("shape,target", [((2, 8, 8, 4), 16), ((2, 7, 7, 2), 8),
                                          ((3, 4, 4, 8), 4096), ((1, 9, 9, 3), 27)])
def test_avgpool_to_and_backward(shape, target):
    rng = np.random.default_rng(target)
    x = rng.integers(-127, 128, shape).astype(np.int32)
    tout, tc = tlayers.avgpool_to(_t(x), target)
    jout, jc = jlayers.avgpool_to(jnp.asarray(x), target)
    _eq(tout, jout)
    assert (tc.in_shape, tc.window, tc.target) == (tuple(jc.in_shape), jc.window, jc.target)
    g = rng.integers(-5000, 5000, tuple(tout.shape)).astype(np.int32)
    _eq(tlayers.avgpool_to_backward(tc, _t(g)), jlayers.avgpool_to_backward(jc, jnp.asarray(g)))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 3])
def test_dropout_forward_backward(rate, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-200, 200, (8, 37)).astype(np.int32)
    tout, tc = tlayers.dropout_forward(prng.PRNGKey(seed), _t(x), rate)
    jout, jc = jlayers.dropout_forward(jax.random.PRNGKey(seed), jnp.asarray(x), rate)
    _eq(tout, jout)
    _eq(tc.mask, jc.mask)
    assert tc.q == jc.q
    g = rng.integers(-(2 ** 20), 2 ** 20, x.shape).astype(np.int32)
    _eq(tlayers.dropout_backward(tc, _t(g)), jlayers.dropout_backward(jc, jnp.asarray(g)))


def test_linear_conv_flatten_forward():
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (2, 5, 6, 3)).astype(np.int32)
    w = rng.integers(-40, 40, (3, 3, 3, 4)).astype(np.int32)
    tz, tc = tlayers.conv_forward({"w": _t(w)}, _t(x))
    jz, jc = jlayers.conv_forward({"w": jnp.asarray(w)}, jnp.asarray(x))
    _eq(tz, jz)
    _eq(tc.x, jc.x)
    tf, tshape = tlayers.flatten_forward(tz)
    jf, jshape = jlayers.flatten_forward(jz)
    _eq(tf, jf)
    assert tshape == tuple(jshape)
    _eq(tlayers.flatten_backward(tshape, tf), jlayers.flatten_backward(jshape, jf))
    wl = rng.integers(-40, 40, (tf.shape[1], 7)).astype(np.int32)
    _eq(tlayers.linear_forward({"w": _t(wl)}, tf)[0],
        jlayers.linear_forward({"w": jnp.asarray(wl)}, jf)[0])


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_preprocessing_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(-300, 900, (50, 8, 8, 3))
    assert tpre.integer_statistics(x) == jpre.integer_statistics(x)
    _eq(tpre.preprocess(x), jpre.preprocess(x))
    _eq(tpre.normalize(x, 5, 0), jpre.normalize(x, 5, 0))  # ω clamped to 1


@pytest.mark.parametrize("name,seed", [("tiles32", 0), ("digits28", 3)])
def test_dataset_and_batches_byte_identical(name, seed):
    t = tsyn.make_image_dataset(name, n_train=96, n_test=32, seed=seed)
    j = jsyn.make_image_dataset(name, n_train=96, n_test=32, seed=seed)
    for a, b in zip(t[:4], j[:4]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert t[4:] == j[4:]
    tb = list(tsyn.batches(t.x_train, t.y_train, 10, seed=seed))
    jb = list(jsyn.batches(j.x_train, j.y_train, 10, seed=seed))
    assert len(tb) == len(jb) == 9
    for (tx, ty), (jx, jy) in zip(tb, jb):
        assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()


# ---------------------------------------------------------------------------
# The slice: gradients, the training step, the trainer
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


def _assert_state_eq(ts, js) -> None:
    for a, b in zip(_param_leaves(ts.params), _param_leaves(js.params), strict=True):
        _eq(a, b)
    for grp in ("opt_lr", "opt_fw"):
        for f in ("gamma_inv", "eta_inv"):
            _eq(getattr(getattr(ts, grp), f), getattr(getattr(js, grp), f))
    _eq(ts.step, js.step)


def _assert_metrics_eq(tm, jm) -> None:
    _eq(tm.loss, jm.loss)
    _eq(tm.correct, jm.correct)
    _eq(tm.local_losses, jm.local_losses)
    assert tm.scaled_loss(BATCH) == jm.scaled_loss(BATCH)


def _states(arch, seed=0):
    tcfg, jcfg = tpaper.get(arch, scale=SCALE), jpaper.get(arch, scale=SCALE)
    ts = tles.create_train_state(prng.PRNGKey(seed), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(seed), jcfg)
    return tcfg, jcfg, ts, js


@pytest.mark.parametrize("arch", ["vgg8b", "vgg11b"])
def test_compute_gradients_matches_jax(arch):
    tcfg, jcfg, ts, js = _states(arch, seed=1)
    _assert_state_eq(ts, js)  # init_params ≡ JAX
    x, y = _batch(tcfg, 0, seed=1)
    tg, tm, _ = tles.compute_gradients(ts, tcfg, _t(x), _t(y), prng.PRNGKey(5))
    jgrad = jax.jit(functools.partial(jles.compute_gradients, cfg=jcfg, backend="reference"))
    jg, jm, _ = jgrad(js, x=jnp.asarray(x), labels=jnp.asarray(y), key=jax.random.PRNGKey(5))
    _assert_metrics_eq(tm, jm)
    for tb, jb in zip(tg.blocks, jg.blocks, strict=True):
        _eq(tb["fw"]["w"], jb["fw"]["w"])
        _eq(tb["lr"]["w"], jb["lr"]["w"])
    _eq(tg.output["w"], jg.output["w"])
    # the unfused forward / unfused δ mask give the same gradients
    ug, um, _ = tles.compute_gradients(ts, tcfg, _t(x), _t(y), prng.PRNGKey(5),
                                    fused=False, fuse_bwd=False)
    for a, b in zip(ug.blocks, tg.blocks):
        assert torch.equal(a["fw"]["w"], b["fw"]["w"])
    assert torch.equal(um.loss, tm.loss)


@pytest.mark.parametrize("arch", ["vgg8b", "vgg11b"])
def test_train_step_trajectory_matches_jax(arch):
    """Three steps from the same key: params, optimiser states, step and
    every step's metrics equal the JAX reference trajectory."""
    tcfg, jcfg, ts, js = _states(arch)
    jstep = jax.jit(functools.partial(jles.train_step, cfg=jcfg, backend="reference"))
    for it in range(3):
        x, y = _batch(tcfg, it)
        ts, tm = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(it))
        js, jm = jstep(js, x=jnp.asarray(x), labels=jnp.asarray(y),
                       key=jax.random.PRNGKey(it))
        _assert_metrics_eq(tm, jm)
        _assert_state_eq(ts, js)


def test_train_step_matches_jax_interpret_kernels():
    """One vgg8b step against the JAX step on its Pallas kernels run in
    interpret mode."""
    tcfg, jcfg, ts, js = _states("vgg8b", seed=2)
    x, y = _batch(tcfg, 0, seed=2)
    ts, tm = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(7), backend="reference")
    js, jm = jles.train_step(js, jcfg, jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(7), backend="interpret")
    _assert_metrics_eq(tm, jm)
    _assert_state_eq(ts, js)


def test_eval_and_plateau_match_jax():
    tcfg, jcfg, ts, js = _states("vgg8b", seed=4)
    x, y = _batch(tcfg, 0, seed=4)
    jeval = jax.jit(functools.partial(jles.eval_step, cfg=jcfg))
    _eq(tles.eval_step(ts, tcfg, _t(x), _t(y)),
        jeval(js, x=jnp.asarray(x), labels=jnp.asarray(y)))
    ts = tles.reduce_lr_on_plateau(ts, True)
    js = jles.reduce_lr_on_plateau(js, True)
    _assert_state_eq(ts, js)


@pytest.mark.parametrize("options", [
    {"telemetry": True},
    {"telemetry": True, "fuse_opt": True},
    {"conv_mode": "materialise", "fuse_opt": True},
], ids=["telemetry", "telemetry-fuse_opt", "materialise-fuse_opt"])
def test_unported_step_options_raise(options):
    """Every step option is ported now, so none raises.  Telemetry, which
    raised here until the observability slice ported it, returns its
    readout beside a state equal to the plain step's, with or without
    fuse_opt; materialised training, which raised until the grad_x slice
    ported it, equals the streamed step."""
    tcfg, _, ts, _ = _states("vgg8b")
    x, y = _batch(tcfg, 0)
    out = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(0), **options)
    got, gm = out[:2]
    assert len(out) == (3 if options.get("telemetry") else 2)
    want, wm = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(0))
    for a, b in zip(_param_leaves(got.params), _param_leaves(want.params), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(gm.loss, wm.loss)


def test_train_nitro_matches_jax(capsys):
    """The trainer on the CPU: same test accuracy and scaled loss as the
    JAX trainer, and the JAX trainer's progress lines."""
    got = ttrain.train_nitro("vgg8b", scale=SCALE, steps=2, batch=8, device="cpu")
    tout = capsys.readouterr().out
    want = jtrain.train_nitro("vgg8b", steps=2, batch=8, ckpt_dir=None,
                              dataset="tiles32", scale=SCALE)
    jout = capsys.readouterr().out
    assert got["steps"] == want["steps"] == 2
    assert got["test_accuracy"] == want["test_accuracy"]
    assert got["scaled_loss"] == want["scaled_loss"]
    assert len(got["step_metrics"]) == 2
    for line in ("step     0", "[done] test accuracy"):
        t_line = next(ln for ln in tout.splitlines() if ln.startswith(line))
        j_line = next(ln for ln in jout.splitlines() if ln.startswith(line))
        assert t_line == j_line
