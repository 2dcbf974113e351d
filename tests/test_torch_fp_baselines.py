"""PyTorch port, FP baselines: ``repro_torch.core.fp_baselines`` ≡
``repro.core.fp_baselines`` (paper Tables 1–2's FP LES / FP BP columns).

The same numpy inputs go through the JAX function and its port on the CPU.
  * Bitwise, dtype included: ``prng.uniform`` / ``bernoulli`` ≡
    ``jax.random.uniform`` / ``bernoulli`` (at every He bound the inits
    draw), ``init_fp_params``, the dropout masks, ``accuracy_fp`` (int32).
  * Float values within ``TOL`` of the JAX value, relative to the largest
    magnitude of the tensor (``_rel``): the forward, both losses and every
    leaf's gradient, and the SGD trajectory of FP LES.
  * FP BP's Adam trajectory by each leaf's absolute error, at most
    ``ADAM_TOL`` of lr per step: Adam's first step moves every weight by
    about ±lr whatever |g| is, so a bound relative to a tiny gradient says
    nothing.
The quickstart example's float count is 0 on the CPU, and its audit
attributes the float64 limb GEMM's operations to it.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import fp_baselines as jfp
from repro.core.blocks import BlockSpec as JSpec
from repro.core.model import NitroConfig as JCfg
from repro_torch.configs import paper as tpaper
from repro_torch.core import fp_baselines as tfp
from repro_torch.core import les, numerics, prng
from repro_torch.core.blocks import BlockSpec as TSpec
from repro_torch.core.model import NitroConfig as TCfg
from repro_torch.parallel.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5        # max |port − JAX| / max |JAX| per tensor
ADAM_TOL = 0.01   # Adam: max |port − JAX| per leaf ≤ ADAM_TOL · lr · steps
MOMENT_TOL = 1e-4  # Adam's mu / nu: relative to the tensor's max |·|
BATCH = 16


def _tiny(spec, cfg, dropout=0.0):
    return cfg(blocks=(spec("conv", 16, pool=True, d_lr=256, dropout=dropout),
                       spec("linear", 64, dropout=dropout)),
               input_shape=(8, 8, 3), num_classes=10)


CONFIGS = {  # name → (JAX config, port config)
    "tiny": (_tiny(JSpec, JCfg), _tiny(TSpec, TCfg)),
    "tiny-dropout": (_tiny(JSpec, JCfg, 0.1), _tiny(TSpec, TCfg, 0.1)),
    "mlp1": (jpaper.get("mlp1"), tpaper.get("mlp1")),
    "vgg8b/16": (jpaper.get("vgg8b", scale=0.0625), tpaper.get("vgg8b", scale=0.0625)),
}


def _data(cfg, n=BATCH, seed=0):
    """Class templates plus noise, as ``tests/test_fp_baselines.py``
    builds them, at ``cfg``'s input shape; float32 x / 64."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(-60, 61, (10, *cfg.input_shape))
    y = rng.integers(0, 10, n).astype(np.int32)
    x = np.clip(templates[y] + rng.integers(-40, 41, (n, *cfg.input_shape)), -127, 127)
    return (x.astype(np.float32) / 64.0), y


def _np(tree) -> list[np.ndarray]:
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _pt(tree) -> list[np.ndarray]:
    return [t.detach().numpy() for t in leaves(tree)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bits_equal(got: np.ndarray, want: np.ndarray) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.reshape(-1).view(np.uint8), want.reshape(-1).view(np.uint8)))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX init of every config, as numpy leaves (jitted once each;
    dropout draws nothing at init, so the tiny configs share one)."""
    init = jax.jit(jfp.init_fp_params, static_argnums=1)
    out = {name: jax.device_get(init(jax.random.PRNGKey(0), CONFIGS[name][0]))
           for name in ("tiny", "mlp1", "vgg8b/16")}
    out["tiny-dropout"] = out["tiny"]
    return out


def _fans(tree) -> list[int]:
    """He fan-ins of a param tree: H·W·C of a conv's HWIO, rows of a matrix."""
    return [math.prod(a.shape[:-1]) for a in _np(tree)]


# ---------------------------------------------------------------------------
# prng.uniform / prng.bernoulli ≡ jax.random, bit for bit
# ---------------------------------------------------------------------------


def test_uniform_bitwise_at_every_he_bound(jax_init):
    """2¹⁵ draws under two keys at every He bound of the tiny config, mlp1
    and VGG8B at 1/16 width, and at asymmetric bounds: bitwise.  The float32
    multiply-add rounded twice misses thousands of them, so the draws are
    enough to tell the forms apart."""
    bounds = sorted({math.sqrt(3.0) / math.sqrt(f)
                     for tree in jax_init.values() for f in _fans(tree)})
    pairs = [(-b, b) for b in bounds] + [(0.0, 1.0), (0.5, 3.0), (-1.0, 2.5), (-7.25, -0.1)]
    n = 1 << 15

    @jax.jit
    def draws(key):
        return [jax.random.uniform(k, (n,), jnp.float32, lo, hi)
                for (lo, hi), k in zip(pairs, jax.random.split(key, len(pairs)))]

    twice = 0
    for seed in (0, 11):
        keys = prng.split(prng.PRNGKey(seed), len(pairs))
        for (lo, hi), k, want in zip(pairs, keys, draws(jax.random.PRNGKey(seed))):
            want = np.asarray(want)
            got = prng.uniform(k, (n,), lo, hi).numpy()
            assert _bits_equal(got, want), (lo, hi, int((got != want).sum()))
            f = (((prng.bits(k, (n,)) >> 9) | 0x3F800000).to(torch.int32)
                 .view(torch.float32) - 1.0).numpy()
            lo32, hi32 = np.float32(lo), np.float32(hi)
            naive = np.maximum(lo32, f * np.float32(hi32 - lo32) + lo32)
            twice += int((naive != want).sum())
    assert len(bounds) >= 10 and twice > 1000


@pytest.mark.parametrize("seed", [0, 1, 42, -5])
@pytest.mark.parametrize("shape", [(), (1,), (7, 3, 5), (2, 3, 4, 5), (64, 257)])
def test_uniform_shapes_and_keys(seed, shape):
    got = prng.uniform(prng.PRNGKey(seed), shape, -0.3, 0.3).numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32,
                                         -0.3, 0.3))
    assert _bits_equal(got, want)
    unit = prng.uniform(prng.PRNGKey(seed), shape).numpy()
    assert _bits_equal(unit, np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape)))


@pytest.mark.parametrize("p", [0.9, 0.5, 0.1, 0.999])
@pytest.mark.parametrize("shape", [(16, 64), (4, 4, 4, 16), (3,)])
def test_bernoulli_bitwise(p, shape):
    for seed in (0, 7):
        got = prng.bernoulli(prng.PRNGKey(seed), p, shape).numpy()
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape))
        assert got.dtype == want.dtype == np.bool_ and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# init, forward, losses, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_bitwise(name, jax_init):
    got = _pt(tfp.init_fp_params(prng.PRNGKey(0), CONFIGS[name][1], device="cpu"))
    want = _np(jax_init[name])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def _port_params(name, jax_init):
    return tfp.fp_params_from_numpy(jax_init[name], device="cpu")


def _jax_forward(jc, train):
    """``jfp.forward_fp`` jitted: (logits, each block's activation)."""
    def fwd(params, x, key):
        logits, locals_ = jfp.forward_fp(params, jc, x, train=train, key=key)
        return logits, [a for _, _, a in locals_]
    return jax.jit(fwd)


@pytest.mark.parametrize("name", ["tiny", "vgg8b/16"])
def test_forward_eval_and_accuracy(name, jax_init):
    jc, tc = CONFIGS[name]
    x, y = _data(tc)
    logits, acts = tfp.forward_fp(_port_params(name, jax_init), tc, torch.from_numpy(x))
    jl, jacts = _jax_forward(jc, False)(jax_init[name], x, None)
    assert logits.dtype == torch.float32 and _rel(logits.numpy(), jl) < TOL
    for (_, _, a), ja in zip(acts, jacts):
        assert a.shape == ja.shape and _rel(a.numpy(), ja) < TOL
    # labels: JAX's prediction for the first half of the batch, another
    # class for the rest, so both counts are BATCH // 2 when argmax agrees
    pred = np.asarray(jl).argmax(-1).astype(np.int32)
    y = np.where(np.arange(BATCH) < BATCH // 2, pred, (pred + 1) % 10).astype(np.int32)
    got = tfp.accuracy_fp(_port_params(name, jax_init), tc, torch.from_numpy(x),
                          torch.from_numpy(y))
    want = np.asarray(jax.jit(jfp.accuracy_fp, static_argnums=1)(jax_init[name], jc, x, y))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert int(got) == int(want) == BATCH // 2


def test_forward_train_masks_bitwise(jax_init):
    """Training forward (VGG8B at 1/16 width, dropout in its linear block):
    each block's dropout mask (from ``split(key, num_blocks)``) is JAX's
    bit for bit, and the activations agree within TOL.  The tiny config's
    conv dropout is held by the trajectories below."""
    name = "vgg8b/16"
    jc, tc = CONFIGS[name]
    x, _ = _data(tc)
    logits, acts = tfp.forward_fp(_port_params(name, jax_init), tc, torch.from_numpy(x),
                                  train=True, key=prng.PRNGKey(5))
    jl, jacts = _jax_forward(jc, True)(jax_init[name], x, jax.random.PRNGKey(5))
    assert _rel(logits.numpy(), jl) < TOL
    keys = prng.split(prng.PRNGKey(5), tc.num_blocks)
    jkeys = jax.random.split(jax.random.PRNGKey(5), jc.num_blocks)
    dropped = 0
    for spec, (_, _, a), ja, k, jk in zip(tc.blocks, acts, jacts, keys, jkeys):
        assert _rel(a.numpy(), ja) < TOL
        if spec.dropout > 0:
            mask = prng.bernoulli(k, 1.0 - spec.dropout, a.shape).numpy()
            assert np.array_equal(mask, np.asarray(
                jax.random.bernoulli(jk, 1.0 - spec.dropout, ja.shape)))
            assert np.array_equal(a.numpy() == 0, ~mask | (np.asarray(ja) == 0))
            dropped += int((~mask).sum())
    assert dropped > 0


@pytest.fixture(scope="module")
def jax_grads(jax_init):
    """JAX's loss and gradients of each loss on VGG8B at 1/16 width, jitted
    once each (the tiny config's are held by the trajectories below)."""
    jc, tc = CONFIGS["vgg8b/16"]
    x, y = _data(tc, seed=1)
    return {loss: jax.device_get(jax.jit(jax.value_and_grad(getattr(jfp, loss)),
                                         static_argnums=1)(
        jax_init["vgg8b/16"], jc, x, y, jax.random.PRNGKey(3)))
        for loss in ("loss_bp", "loss_les")}


@pytest.mark.parametrize("loss", ["loss_bp", "loss_les"])
def test_loss_and_every_gradient(loss, jax_init, jax_grads):
    name = "vgg8b/16"
    _, tc = CONFIGS[name]
    x, y = _data(tc, seed=1)
    val, grads = tfp.value_and_grad(getattr(tfp, loss), _port_params(name, jax_init), tc,
                                    torch.from_numpy(x), torch.from_numpy(y),
                                    prng.PRNGKey(3))
    jval, jgrads = jax_grads[loss]
    assert val.dtype == torch.float32 and _rel(val.numpy(), jval) < TOL
    got, want = _pt(grads), _np(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if not w.any():  # FP BP never reaches the lr heads: zero, as JAX's
            assert loss == "loss_bp" and not g.any()
            continue
        assert _rel(g, w) < TOL


# ---------------------------------------------------------------------------
# trajectories, the Adam state carried across
# ---------------------------------------------------------------------------

STEPS = 3
NAME = "tiny-dropout"


@pytest.fixture(scope="module")
def jax_runs(jax_init):
    """3 FP BP (Adam, lr 1e-3) and 3 FP LES (SGD, lr 2e-2) steps in JAX from
    the tiny dropout config's init, each state after each step as numpy."""
    jc, tc = CONFIGS[NAME]
    bp = jax.jit(jfp.train_step_bp, static_argnums=2)
    lesf = jax.jit(jfp.train_step_les, static_argnums=1, static_argnames="lr")
    params, opt = jax_init[NAME], jfp.adam_init(jax_init[NAME])
    les_params = jax_init[NAME]
    runs = {"bp": [], "les": []}
    for i in range(STEPS):
        x, y = _data(tc, seed=10 + i)
        params, opt, loss = bp(params, opt, jc, x, y, jax.random.PRNGKey(i))
        runs["bp"].append(jax.device_get((params, opt, loss)))
        les_params, loss = lesf(les_params, jc, x, y, jax.random.PRNGKey(i), lr=2e-2)
        runs["les"].append(jax.device_get((les_params, loss)))
    return runs


def _adam_close(got, want, lr, steps):
    for g, w in zip(_pt(got), _np(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.abs(g.astype(np.float64) - w).max() <= ADAM_TOL * lr * steps


def _moments_close(state, jstate):
    for g, w in zip(_pt(state.mu) + _pt(state.nu), _np(jstate[0]) + _np(jstate[1])):
        if w.any():
            assert _rel(g, w) < MOMENT_TOL
        else:  # the lr heads under FP BP: zero gradients, zero moments
            assert not g.any()
    assert state.count.dtype == torch.int32 and int(state.count) == int(jstate[2])


def test_bp_trajectory(jax_init, jax_runs):
    _, tc = CONFIGS[NAME]
    params = _port_params(NAME, jax_init)
    opt = tfp.adam_init(params)
    for i, (jparams, jopt, jloss) in enumerate(jax_runs["bp"]):
        x, y = _data(tc, seed=10 + i)
        params, opt, loss = tfp.train_step_bp(params, opt, tc, torch.from_numpy(x),
                                              torch.from_numpy(y), prng.PRNGKey(i))
        assert _rel(loss.numpy(), jloss) < TOL
        _adam_close(params, jparams, 1e-3, i + 1)
    _moments_close(opt, jopt)


def test_adam_state_carried_across(jax_runs):
    """JAX's state after step 1 carried across (``fp_params_from_numpy``,
    ``adam_state_from_numpy``); the port's step 2 from it is JAX's."""
    _, tc = CONFIGS[NAME]
    jparams, jopt, _ = jax_runs["bp"][0]
    params = tfp.fp_params_from_numpy(jparams, device="cpu")
    opt = tfp.adam_state_from_numpy(jopt, device="cpu")
    assert int(opt.count) == 1 and opt.count.dtype == torch.int32
    x, y = _data(tc, seed=11)
    params, opt, loss = tfp.train_step_bp(params, opt, tc, torch.from_numpy(x),
                                          torch.from_numpy(y), prng.PRNGKey(1))
    want_params, want_opt, want_loss = jax_runs["bp"][1]
    assert _rel(loss.numpy(), want_loss) < TOL
    _adam_close(params, want_params, 1e-3, 1)
    _moments_close(opt, want_opt)
    with pytest.raises(TypeError, match="int32"):
        tfp.adam_state_from_numpy((jopt[0], jopt[1], np.int64(1)), device="cpu")
    with pytest.raises(TypeError, match="float32"):
        tfp.fp_params_from_numpy(jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                                        jparams), device="cpu")


def test_les_trajectory(jax_init, jax_runs):
    _, tc = CONFIGS[NAME]
    params = _port_params(NAME, jax_init)
    for i, (jparams, jloss) in enumerate(jax_runs["les"]):
        x, y = _data(tc, seed=10 + i)
        params, loss = tfp.train_step_les(params, tc, torch.from_numpy(x),
                                          torch.from_numpy(y), prng.PRNGKey(i), lr=2e-2)
        assert _rel(loss.numpy(), jloss) < TOL
        for g, w in zip(_pt(params), _np(jparams)):
            assert g.dtype == w.dtype and _rel(g, w) < TOL


# ---------------------------------------------------------------------------
# ports of tests/test_fp_baselines.py, on the port alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    _, tc = CONFIGS["tiny"]
    x, y = _data(tc, n=64)
    return tc, torch.from_numpy(x), torch.from_numpy(y)


def test_bp_learns(setup):
    cfg, x, y = setup
    params = tfp.init_fp_params(prng.PRNGKey(0), cfg, device="cpu")
    opt = tfp.adam_init(params)
    losses = []
    for i in range(60):
        params, opt, loss = tfp.train_step_bp(params, opt, cfg, x, y, prng.PRNGKey(i))
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0]
    assert int(tfp.accuracy_fp(params, cfg, x, y)) > 32


def test_les_learns_with_confined_gradients(setup):
    cfg, x, y = setup
    params = tfp.init_fp_params(prng.PRNGKey(0), cfg, device="cpu")
    losses = []
    for i in range(150):
        params, loss = tfp.train_step_les(params, cfg, x, y, prng.PRNGKey(i), lr=2e-2)
        losses.append(float(loss))
    assert losses[-1] < 0.8 * losses[0]
    assert int(tfp.accuracy_fp(params, cfg, x, y)) > 20  # 64 samples, chance 6.4


def test_stop_gradient_confines(setup):
    """Gradient of block-0 params wrt the LES loss is unaffected by a
    downstream weight perturbation (the same invariant as integer LES)."""
    cfg, x, y = setup
    params = tfp.init_fp_params(prng.PRNGKey(0), cfg, device="cpu")
    _, g1 = tfp.value_and_grad(tfp.loss_les, params, cfg, x, y, prng.PRNGKey(0))
    params2 = {"blocks": [dict(b) for b in params["blocks"]],
               "output": params["output"] + 0.5}
    params2["blocks"][1]["fw"] = params2["blocks"][1]["fw"] * 1.1
    _, g2 = tfp.value_and_grad(tfp.loss_les, params2, cfg, x, y, prng.PRNGKey(0))
    np.testing.assert_allclose(g1["blocks"][0]["fw"].numpy(), g2["blocks"][0]["fw"].numpy(),
                               rtol=1e-6)
    assert not torch.equal(g1["blocks"][1]["lr"], g2["blocks"][1]["lr"]) or \
        not torch.equal(g1["output"], g2["output"])


def test_full_fp32_is_scoped():
    """Inside an FP call cuDNN convs and cuBLAS matmuls are IEEE float32;
    after it the caller's settings are back."""
    def state():
        return torch.backends.cudnn.conv.fp32_precision, \
            torch.backends.cuda.matmul.fp32_precision

    before = state()
    seen = []
    real_conv = tfp._conv

    def probe(x, w):
        seen.append(state())
        return real_conv(x, w)

    cfg = CONFIGS["tiny"][1]
    params = tfp.init_fp_params(prng.PRNGKey(0), cfg, device="cpu")
    x, y = _data(cfg)
    tfp._conv = probe
    try:
        tfp.train_step_les(params, cfg, torch.from_numpy(x), torch.from_numpy(y),
                           prng.PRNGKey(0))
    finally:
        tfp._conv = real_conv
    assert seen == [("ieee", "ieee")] and state() == before


# ---------------------------------------------------------------------------
# the quickstart example's float audit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart():
    spec = importlib.util.spec_from_file_location(
        "examples_torch_quickstart", ROOT / "examples_torch" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_counts_no_float_on_the_cpu(quickstart):
    """One integer train step (two blocks at 8×8, dropout on) on the CPU:
    no aten operation takes or gives a floating-point tensor."""
    cfg = TCfg(blocks=(TSpec("conv", 8, pool=True, d_lr=64),
                       TSpec("linear", 16, dropout=0.1)),
               input_shape=(8, 8, 3), num_classes=10)
    state = les.create_train_state(prng.PRNGKey(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-127, 128, (4, 8, 8, 3)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 10, 4).astype(np.int32))
    audit = quickstart.audit_train_step(state, cfg, x, y, prng.PRNGKey(1))
    assert audit.n_float == 0, dict(audit.ops)


def test_quickstart_audit_sees_and_attributes_floats(quickstart):
    """The audit counts float tensors, and tells the float64 limb GEMM's
    operations (the card's int_matmul) from the others."""
    a = torch.tensor([[3, -70000]], dtype=torch.int32)
    w = torch.tensor([[5], [2]], dtype=torch.int32)
    with quickstart.FloatAudit() as audit:
        got = numerics._matmul_f64_exact(a, w)
        (torch.ones(2) * 2).sum()
    assert torch.equal(got, a @ w)
    inside = {op for (op, ins), _ in audit.ops.items() if ins}
    outside = {op for (op, ins), _ in audit.ops.items() if not ins}
    assert "aten.mm.default" in inside and "aten.mul.Tensor" in outside
    assert audit.n_float == sum(audit.ops.values()) > 0
