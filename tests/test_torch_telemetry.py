"""PyTorch port, integer telemetry ≡ the JAX package's, bitwise, on the CPU.

  * the reductions (``bit_width``, ``bit_occupancy``, ``tensor_telemetry``,
    ``relu_dead_count``) on seeded int8 and int32 inputs with 0, ±1, ±2ᵏ,
    ±(2ᵏ−1), INT32_MIN and INT32_MAX planted, dtype included;
  * ``train_step(telemetry=True)`` ≡ the port's plain step (trajectory and
    metrics bitwise) and its telemetry pytree ≡ JAX's, leaf for leaf, on a
    tiny conv net, VGG8B at scale 0.0625 and mlp1; ``fuse_opt`` with
    telemetry ≡ the split telemetry step;
  * ``compute_gradients`` returns ``StepAux`` with JAX's cache keys;
  * the train CLI's ``metrics.jsonl`` is byte for byte the JAX launcher's.

JAX runs its plain reference (``backend="reference"``, jitted); the port
runs with ``device="cpu"``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import les as jles
from repro.core.blocks import BlockSpec as JBlockSpec
from repro.core.model import NitroConfig as JNitroConfig
from repro.launch import train as jtrain
from repro.obs import telemetry as JT
from repro_torch.configs import paper as tpaper
from repro_torch.core import les as tles
from repro_torch.core import prng
from repro_torch.core.blocks import BlockSpec as TBlockSpec
from repro_torch.core.model import NitroConfig as TNitroConfig
from repro_torch.core.numerics import ACT_MAX, ACT_MIN
from repro_torch.launch import train as ttrain
from repro_torch.obs import telemetry as T

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max
SCALE = 0.0625


def _eq(t, j) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    assert got.shape == j.shape, (got.shape, j.shape)
    assert np.array_equal(got, j)


def _tree_eq(t, j, path="telem") -> int:
    """Leaf-for-leaf equality of a port and a JAX pytree; returns the
    number of leaves compared."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and sorted(t) == sorted(j), path
        return sum(_tree_eq(t[k], j[k], f"{path}.{k}") for k in j)
    if isinstance(j, (list, tuple)):
        assert type(t).__name__ == type(j).__name__ and len(t) == len(j), path
        return sum(_tree_eq(a, b, f"{path}[{i}]") for i, (a, b) in enumerate(zip(t, j)))
    assert isinstance(t, torch.Tensor), path
    assert not t.dtype.is_floating_point, path
    _eq(t, j)
    return 1


def _planted(dtype, seed=0, n=4096) -> np.ndarray:
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    vals = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True)
    planted = [0, 1, -1, int(info.min), int(info.max), int(info.min) + 1]
    for k in range(1, info.bits - 1):
        planted += [2 ** k, -(2 ** k), 2 ** k - 1, -(2 ** k - 1)]
    planted = [v for v in planted if info.min <= v <= info.max]
    vals[:len(planted)] = planted
    rng.shuffle(vals)
    return vals.astype(dtype)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.int8])
@pytest.mark.parametrize("shape", [(4096,), (8, 16, 32)])
def test_bit_width_matches_jax(dtype, shape):
    vals = _planted(dtype).reshape(shape)
    got = T.bit_width(torch.from_numpy(vals))
    _eq(got, JT.bit_width(jnp.asarray(vals)))
    want = np.array([32 if v == INT32_MIN else abs(int(v)).bit_length()
                     for v in vals.ravel()], np.int32).reshape(shape)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int8])
def test_bit_occupancy_and_tensor_telemetry_match_jax(dtype):
    vals = _planted(dtype, seed=1).reshape(64, 64)
    _eq(T.bit_occupancy(torch.from_numpy(vals)), JT.bit_occupancy(jnp.asarray(vals)))
    got, want = T.tensor_telemetry(torch.from_numpy(vals)), JT.tensor_telemetry(jnp.asarray(vals))
    assert _tree_eq(got, want) == 4
    assert int(got.bit_hist.sum()) == vals.size


def test_tensor_telemetry_saturation_and_max():
    vals = np.array([0, 1, -127, 127, 128, -129, 2 ** 30, INT32_MIN], np.int32)
    tt = T.tensor_telemetry(torch.from_numpy(vals))
    assert int(tt.sat_int8) == 4 and int(tt.sat_int32) == 2
    assert int(tt.max_abs) == INT32_MAX  # INT32_MIN maps to the max magnitude
    assert _tree_eq(tt, JT.tensor_telemetry(jnp.asarray(vals))) == 4


def test_relu_dead_count_matches_jax():
    rng = np.random.default_rng(2)
    z = np.concatenate([[ACT_MIN - 1, ACT_MIN, 0, ACT_MAX, ACT_MAX + 1, INT32_MIN, INT32_MAX],
                        rng.integers(-400, 400, 1000)]).astype(np.int32)
    _eq(T.relu_dead_count(torch.from_numpy(z)), JT.relu_dead_count(jnp.asarray(z)))
    assert int(T.relu_dead_count(torch.from_numpy(z[:5]))) == 2


# ---------------------------------------------------------------------------
# The telemetry step
# ---------------------------------------------------------------------------


def _tiny(pkg):
    spec, cfg = (TBlockSpec, TNitroConfig) if pkg == "torch" else (JBlockSpec, JNitroConfig)
    return cfg(blocks=(spec("conv", 8, pool=True, d_lr=64), spec("linear", 16)),
               input_shape=(8, 8, 3), num_classes=10, gamma_inv=512, name="tiny-obs")


def _cfgs(arch):
    if arch == "tiny":
        return _tiny("torch"), _tiny("jax")
    return tpaper.get(arch, scale=SCALE), jpaper.get(arch, scale=SCALE)


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (n, *cfg.input_shape)).astype(np.int32),
            rng.integers(0, cfg.num_classes, n).astype(np.int32))


def _state_leaves(state):
    out = [state.step, state.opt_lr.gamma_inv, state.opt_lr.eta_inv,
           state.opt_fw.gamma_inv, state.opt_fw.eta_inv, state.params["output"]["w"]]
    for b in state.params["blocks"]:
        out += [b["fw"]["w"], b["lr"]["w"]]
    return out


def _same_state(a, b):
    for x, y in zip(_state_leaves(a), _state_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _same_metrics(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch,batch,steps", [("tiny", 8, 3), ("vgg8b", 4, 2), ("mlp1", 4, 2)])
def test_telemetry_step_matches_plain_step_and_jax(arch, batch, steps):
    """Telemetry on vs off: the same trajectory and metrics bitwise; every
    step's telemetry pytree equals the JAX step's, leaf for leaf."""
    tcfg, jcfg = _cfgs(arch)
    x, y = _batch(tcfg, batch, seed=3)
    plain = instr = tles.create_train_state(prng.PRNGKey(0), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(0), jcfg)
    jstep = jax.jit(functools.partial(jles.train_step, cfg=jcfg, telemetry=True,
                                      backend="reference"))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for it in range(steps):
        plain, pm = tles.train_step(plain, tcfg, tx, ty, prng.PRNGKey(100 + it))
        instr, im, telem = tles.train_step(instr, tcfg, tx, ty, prng.PRNGKey(100 + it),
                                           telemetry=True)
        js, jm, jtelem = jstep(js, x=jnp.asarray(x), labels=jnp.asarray(y),
                               key=jax.random.PRNGKey(100 + it))
        _same_state(instr, plain)
        _same_metrics(im, pm)
        n = _tree_eq(telem, jtelem)
        assert n == 4 * (4 * len(tcfg.blocks) + 2) + len(tcfg.blocks) + 4
        _eq(im.loss, jm.loss)
    records = T.to_records(telem, cfg=tcfg, step=steps)
    assert records == JT.to_records(jtelem, cfg=jcfg, step=steps)
    assert [r["layer"] for r in records] == (
        [f"block{i}" for i in range(len(tcfg.blocks))] + ["output", "_opt"])


def test_fuse_opt_telemetry_step_is_the_split_telemetry_step():
    tcfg = tpaper.get("vgg8b", scale=SCALE)
    x, y = (torch.from_numpy(a) for a in _batch(tcfg, 4, seed=4))
    split = fused = tles.create_train_state(prng.PRNGKey(1), tcfg, device="cpu")
    for it in range(2):
        split, sm, st = tles.train_step(split, tcfg, x, y, prng.PRNGKey(it), telemetry=True)
        fused, fm, ft = tles.train_step(fused, tcfg, x, y, prng.PRNGKey(it), telemetry=True,
                                        fuse_opt=True)
        _same_state(fused, split)
        _same_metrics(fm, sm)
        assert T.to_records(ft, cfg=tcfg, step=it) == T.to_records(st, cfg=tcfg, step=it)
    # and the fuse_opt step without telemetry keeps the same trajectory
    plain = tles.create_train_state(prng.PRNGKey(1), tcfg, device="cpu")
    for it in range(2):
        plain, _ = tles.train_step(plain, tcfg, x, y, prng.PRNGKey(it), fuse_opt=True)
    _same_state(plain, split)


def test_compute_gradients_returns_step_aux_with_jax_caches():
    tcfg, jcfg = _cfgs("tiny")
    x, y = _batch(tcfg, 4, seed=5)
    ts = tles.create_train_state(prng.PRNGKey(2), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(2), jcfg)
    grads, metrics, aux = tles.compute_gradients(ts, tcfg, torch.from_numpy(x),
                                                 torch.from_numpy(y), prng.PRNGKey(9))
    jgrad = jax.jit(functools.partial(jles.compute_gradients, cfg=jcfg, backend="reference"))
    _, _, jaux = jgrad(js, x=jnp.asarray(x), labels=jnp.asarray(y), key=jax.random.PRNGKey(9))
    assert isinstance(aux, tles.StepAux) and tles.StepAux._fields == jles.StepAux._fields
    assert isinstance(aux.fw_caches, tuple) and len(aux.fw_caches) == len(jaux.fw_caches)
    for tc, jc in zip(aux.fw_caches, jaux.fw_caches):
        assert sorted(tc) == sorted(jc)
        _eq(tc["z_star"], jc["z_star"])
        _eq(tc["act"], jc["act"])


def test_to_records_and_append_jsonl(tmp_path):
    tcfg = _tiny("torch")
    x, y = (torch.from_numpy(a) for a in _batch(tcfg, 4, seed=6))
    state = tles.create_train_state(prng.PRNGKey(0), tcfg, device="cpu")
    _, _, telem = tles.train_step(state, tcfg, x, y, prng.PRNGKey(1), telemetry=True)
    records = T.to_records(telem, cfg=tcfg, step=7)
    for rec in records[:2]:
        z = rec["z_star"]
        assert rec["step"] == 7 and sum(z["bit_hist"]) == z["total"]
        assert rec["dead"] == pytest.approx(rec["dead_frac"] * z["total"])
    assert all(isinstance(records[-1][k], int)
               for k in ("gamma_inv_lr", "eta_inv_lr", "gamma_inv_fw", "eta_inv_fw"))
    path = str(tmp_path / "ckpts" / "metrics.jsonl")  # parent made on demand
    T.append_jsonl(path, records)
    T.append_jsonl(path, records)  # appends, never truncates
    jpath = str(tmp_path / "jax.jsonl")
    JT.append_jsonl(jpath, records)
    JT.append_jsonl(jpath, records)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The port's and the JAX launcher's ``train_nitro`` with the same
    arguments and telemetry every 2nd step."""
    d = tmp_path_factory.mktemp("telemetry_cli")
    kw = dict(steps=4, batch=8, scale=SCALE, telemetry_every=2)
    got = ttrain.train_nitro("vgg8b", device="cpu", telemetry_out=str(d / "torch.jsonl"),
                             trace_out=str(d / "torch_trace.jsonl"), **kw)
    want = jtrain.train_nitro("vgg8b", ckpt_dir=None, dataset="tiles32",
                              telemetry_out=str(d / "jax.jsonl"),
                              trace_out=str(d / "jax_trace.jsonl"), **kw)
    return d, got, want


def test_train_cli_metrics_jsonl_is_jax_byte_for_byte(cli_runs):
    d, got, want = cli_runs
    data = (d / "torch.jsonl").read_bytes()
    assert data == (d / "jax.jsonl").read_bytes()
    rows = [json.loads(ln) for ln in data.decode().splitlines()]
    assert sorted({r["step"] for r in rows}) == [0, 2]
    assert len(rows) == 2 * (len(tpaper.get("vgg8b").blocks) + 2)
    assert got["health"] == want["health"]
    assert got["test_accuracy"] == want["test_accuracy"]
    assert got["scaled_loss"] == want["scaled_loss"]


def test_train_cli_trace_matches_jax_spans(cli_runs):
    d, _, _ = cli_runs

    def spans(name):
        return [json.loads(ln) for ln in (d / name).read_text().splitlines()]

    every, j = spans("torch_trace.jsonl"), spans("jax_trace.jsonl")
    # the CLI loop's own spans match the JAX CLI's; the port's tracer also
    # holds the step's inner spans (obs.trace.use), each under a train.step
    t = [s for s in every if s["name"].startswith("train.")]
    assert [(s["name"], s["attrs"]) for s in t] == [(s["name"], s["attrs"]) for s in j]
    assert [s["name"] for s in t].count("train.step") == 4 and t[-1]["name"] == "train.eval"
    assert [s["attrs"]["telemetry"] for s in t[:4]] == [True, False, True, False]
    by_id = {s["span_id"]: s["name"] for s in every}
    assert [by_id[s["parent_id"]] for s in every if s["name"] == "step.train"] == ["train.step"] * 4
