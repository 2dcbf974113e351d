"""PyTorch port, ``infer/export`` held against the JAX package.

  * ``quantization_report`` ≡ JAX's, and ``QUANT_REPORT.json`` byte for
    byte, on the paper archs at small width and on a handcrafted model
    with int16/int32 weights and −2ᵏ edges;
  * ``save_frozen`` directories cross both ways: leaf ``.npy`` files,
    ``LATEST`` and the report byte-identical, ``MANIFEST.json`` equal but
    for ``"time"``, weights and dtypes equal after each package's
    ``load_frozen``;
  * ``prune_frozen`` / ``keep_last`` / rollback re-exports leave the same
    steps, ``LATEST`` and return values on the same step sets;
  * ``FLEET.json`` round-trips between the packages, and a hand-edited
    bad manifest is rejected by both with the same message;
  * JAX ``save_frozen`` → port ``load_frozen`` → plan ≡ the JAX plan for
    vgg11b, vgg8b at the digits28 input, mlp1 and mlp4 after 2 steps;
  * ``model.count_params`` and ``numerics.clip_act`` ≡ JAX's.

Tolerance zero, dtype included.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import les as jles
from repro.core import model as JM
from repro.core import numerics as jnum
from repro.data import synthetic as jsyn
from repro.infer import compile_plan as j_compile_plan
from repro.infer import export as jexp
from repro_torch.configs import paper as tpaper
from repro_torch.core import model as TM
from repro_torch.core import numerics as tnum
from repro_torch.core import prng
from repro_torch.infer import compile_plan
from repro_torch.infer import export as texp

SCALE = 0.0625
ARCHS = ["vgg8b", "vgg11b", "mlp1", "mlp4"]


def _eq(t, j) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    np.testing.assert_array_equal(got, j)


@functools.lru_cache(maxsize=None)
def _models(arch, seed=0, input_shape=None):
    """The same init frozen by both packages: (port fm, JAX fm); read-only."""
    jcfg = jpaper.get(arch, scale=SCALE, input_shape=input_shape)
    cfg = tpaper.get(arch, scale=SCALE, input_shape=input_shape)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return (texp.freeze(TM.params_from_numpy(np_tree, device="cpu"), cfg),
            jexp.freeze(jparams, jcfg))


def _handcrafted():
    """int8 / int16 / int32 weights on the two's-complement edges: −2ᵏ
    (which fit k + 1 bits), 2ᵏ − 1, an all-zero layer, INT32_MIN."""
    rng = np.random.default_rng(4)
    conv = rng.integers(-8, 8, (3, 3, 2, 4)).astype(np.int8)
    conv.flat[:2] = (-8, 7)                                # exactly 4 bits
    lin = rng.integers(-300, 300, (16 * 16 * 4 // 4, 8)).astype(np.int16)
    lin.flat[:3] = (-32768, 256, -256)                     # 16 bits, −2⁸
    zero = np.zeros((8, 8), np.int8)                       # 1 bit, all zero
    out = rng.integers(-5, 5, (8, 10)).astype(np.int32)
    out.flat[:3] = (-(2 ** 31), 2 ** 31 - 1, -(2 ** 20))   # 32 bits
    specs = [("conv", conv, 9, 10, True, True), ("linear", lin, 64, 2, True, False),
             ("linear", zero, 8, 10, True, False), ("output", out, 8, 0, False, False)]
    t = texp.FrozenModel(
        layers=tuple(texp.FrozenLayer(k, torch.from_numpy(w), sf, a, r, p)
                     for k, w, sf, a, r, p in specs),
        input_shape=(4, 4, 2), num_classes=10, name="edges")
    j = jexp.FrozenModel(
        layers=tuple(jexp.FrozenLayer(k, jnp.asarray(w), sf, a, r, p)
                     for k, w, sf, a, r, p in specs),
        input_shape=(4, 4, 2), num_classes=10, name="edges")
    return t, j


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("arch", ARCHS + ["handcrafted"])
def test_quantization_report_matches_jax(arch, tmp_path):
    fm, jfm = _handcrafted() if arch == "handcrafted" else _models(arch)
    report = texp.quantization_report(fm)
    assert report == jexp.quantization_report(jfm)
    assert report["layers"][0]["dtype"] == str(np.asarray(jfm.layers[0].w).dtype)
    if arch == "handcrafted":
        assert [l["bit_width"] for l in report["layers"]] == [4, 16, 1, 32]
        assert [l["dtype"] for l in report["layers"]] == ["int8", "int16", "int8", "int32"]
    ours = texp.save_frozen(str(tmp_path / "port"), fm)
    theirs = jexp.save_frozen(str(tmp_path / "jax"), jfm)
    assert _read(os.path.join(ours, texp.REPORT_FILENAME)) == \
        _read(os.path.join(theirs, jexp.REPORT_FILENAME))


@pytest.mark.parametrize("arch", ARCHS + ["handcrafted"])
def test_save_frozen_crosses_both_ways(arch, tmp_path):
    fm, jfm = _handcrafted() if arch == "handcrafted" else _models(arch)
    ours = texp.save_frozen(str(tmp_path / "port"), fm)
    theirs = jexp.save_frozen(str(tmp_path / "jax"), jfm)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    for name in names:
        if name.endswith(".npy") or name == texp.REPORT_FILENAME:
            assert _read(os.path.join(ours, name)) == _read(os.path.join(theirs, name)), name
    m_ours = json.loads(_read(os.path.join(ours, "MANIFEST.json")))
    m_theirs = json.loads(_read(os.path.join(theirs, "MANIFEST.json")))
    m_ours.pop("time"), m_theirs.pop("time")
    assert m_ours == m_theirs
    assert _read(tmp_path / "port" / "LATEST") == _read(tmp_path / "jax" / "LATEST")
    for loaded_j, loaded_t in ((jexp.load_frozen(str(tmp_path / "port")), fm),
                               (jfm, texp.load_frozen(str(tmp_path / "jax")))):
        assert loaded_j.input_shape == loaded_t.input_shape
        assert (loaded_j.name, loaded_j.num_classes) == (loaded_t.name, loaded_t.num_classes)
        for lj, lt in zip(loaded_j.layers, loaded_t.layers):
            assert (lj.kind, lj.sf, lj.alpha_inv, lj.apply_relu, lj.pool) == \
                (lt.kind, lt.sf, lt.alpha_inv, lt.apply_relu, lt.pool)
            _eq(lt.w, lj.w)


#: save/prune sequences: (step, keep_last) per save, then a prune_frozen
PRUNE_CASES = [
    ([(None, None)] * 4 + [(None, 2)], 1),
    ([(None, None)] * 3 + [(1, None), (None, None)], 2),  # rollback, auto = 3
    ([(5, None), (3, None)], 1),                           # LATEST is not newest
    ([(None, None), (7, None), (None, None), (2, 1)], 1),
    ([(None, 3)] * 6, 2),
]


@pytest.mark.parametrize("saves,keep", PRUNE_CASES)
def test_prune_keep_last_and_rollback_match_jax(saves, keep, tmp_path):
    steps_seen = {}
    for pkg, exp in (("port", texp), ("jax", jexp)):
        d = str(tmp_path / pkg)
        pairs = [_models("mlp1", seed=s) for s in range(2)]
        got = []
        for i, (step, keep_last) in enumerate(saves):
            fm = pairs[i % 2][0 if pkg == "port" else 1]
            got.append(os.path.basename(exp.save_frozen(d, fm, step=step,
                                                        keep_last=keep_last)))
        got.append(exp.prune_frozen(d, keep_last=keep))
        got.append(sorted(os.listdir(d)))
        got.append(_read(os.path.join(d, "LATEST")))
        w0 = exp.load_frozen(d).layers[0].w
        got.append(np.asarray(w0.numpy() if isinstance(w0, torch.Tensor) else w0).tobytes())
        steps_seen[pkg] = got
    assert steps_seen["port"] == steps_seen["jax"]
    with pytest.raises(ValueError, match="keep_last"):
        texp.prune_frozen(str(tmp_path / "port"), keep_last=0)


def test_fleet_manifest_round_trips_between_packages(tmp_path):
    fm, jfm = _models("mlp1")
    jexp.save_frozen(str(tmp_path / "a"), jfm)
    texp.save_frozen(str(tmp_path / "b"), fm)
    models = {"a": "a", "b": str(tmp_path / "b")}  # relative and absolute
    splits = {"s": {"a": 0.9, "b": 0.1}, "t": {"b": 3.0}}
    jexp.save_fleet_manifest(str(tmp_path), models, splits=splits)
    jax_bytes = _read(tmp_path / "FLEET.json")
    loaded = texp.load_fleet_manifest(str(tmp_path))
    assert loaded == jexp.load_fleet_manifest(str(tmp_path))
    assert loaded["models"]["a"] == str(tmp_path / "a")
    texp.save_fleet_manifest(str(tmp_path), models, splits=splits)
    assert _read(tmp_path / "FLEET.json") == jax_bytes
    assert jexp.load_fleet_manifest(str(tmp_path)) == loaded
    from repro_torch.serving import ModelRegistry

    reg = ModelRegistry.from_manifest(str(tmp_path), device="cpu")
    assert reg.ids() == ["a", "b"] and reg.get("a").plan.name == "mlp1"


@pytest.mark.parametrize("edit,match", [
    (lambda m: m["splits"].update(s={"ghost": 1.0}), "unknown models"),
    (lambda m: m["splits"].update(a={"a": 1.0}), "shadows"),
    (lambda m: m.update(models={}, splits={}), "at least one model"),
    (lambda m: m.update(format="nitro-fleet-v0"), "not a fleet manifest"),
])
def test_hand_edited_manifest_rejected_by_both(edit, match, tmp_path):
    texp.save_fleet_manifest(str(tmp_path), {"a": "a"})
    meta = json.loads(_read(tmp_path / "FLEET.json"))
    edit(meta)
    (tmp_path / "FLEET.json").write_text(json.dumps(meta))
    errors = []
    for exp in (texp, jexp):
        with pytest.raises(ValueError, match=match) as e:
            exp.load_fleet_manifest(str(tmp_path))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(FileNotFoundError, match="no FLEET.json"):
        texp.load_fleet_manifest(str(tmp_path / "missing"))


def _jax_trained(arch, steps, batch=4):
    """JAX mlp state after ``steps`` LES steps on flattened tiles32."""
    ds = jsyn.flatten_for_mlp(jsyn.make_image_dataset("tiles32", n_train=64,
                                                      n_test=8, seed=0))
    jcfg = jpaper.get(arch, scale=SCALE)
    state = jles.create_train_state(jax.random.PRNGKey(0), jcfg)
    step = jax.jit(functools.partial(jles.train_step, cfg=jcfg))
    for it, (x, y) in zip(range(steps), jsyn.batches(ds.x_train, ds.y_train, batch)):
        state, _ = step(state, x=jnp.asarray(x), labels=jnp.asarray(y),
                        key=jax.random.PRNGKey(it))
    return jcfg, state


#: JAX save_frozen → port load_frozen → plan, the configurations no other
#: test holds
ROUND_TRIPS = {
    "vgg11b": lambda: (jpaper.get("vgg11b", scale=SCALE), None),
    "vgg8b-digits28": lambda: (jpaper.get("vgg8b", scale=SCALE, input_shape=(28, 28, 1)),
                               None),
    "mlp1": lambda: (jpaper.get("mlp1", scale=SCALE), None),
    "mlp4-2-steps": lambda: _jax_trained("mlp4", 2),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_jax_save_frozen_loads_into_port_plan(case, tmp_path):
    jcfg, state = ROUND_TRIPS[case]()
    if state is None:
        state = jles.create_train_state(jax.random.PRNGKey(1), jcfg)
    jfm = jexp.freeze(state, jcfg)
    jexp.save_frozen(str(tmp_path), jfm)
    fm = texp.load_frozen(str(tmp_path))
    plan = compile_plan(fm, device="cpu")
    jplan = j_compile_plan(jfm, backend="reference")
    x = np.random.default_rng(6).integers(-127, 128, (3, *fm.input_shape)).astype(np.int32)
    _eq(plan.logits(x), jplan.logits(jnp.asarray(x)))
    _eq(plan.predict(x), jplan.predict(jnp.asarray(x)))
    assert plan.summary() == jplan.summary()


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_jax(arch):
    jcfg = jpaper.get(arch, scale=SCALE)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TM.init_params(prng.PRNGKey(0), tpaper.get(arch, scale=SCALE), device="cpu")
    assert TM.count_params(params) == JM.count_params(jparams)
    assert TM.count_params({"a": None, "b": [params["output"]]}) == \
        JM.count_params({"a": None, "b": [jparams["output"]]})


def test_clip_act_matches_jax():
    x = np.array([-(2 ** 31), -128, -127, -1, 0, 1, 127, 128, 2 ** 31 - 1], np.int32)
    _eq(tnum.clip_act(torch.from_numpy(x)), jnum.clip_act(jnp.asarray(x)))
    r = np.random.default_rng(0).integers(-1000, 1000, (7, 5)).astype(np.int32)
    _eq(tnum.clip_act(torch.from_numpy(r)), jnum.clip_act(jnp.asarray(r)))


def test_freeze_takes_a_train_state():
    from repro_torch.core import les as tles

    cfg = tpaper.get("mlp1", scale=SCALE)
    state = tles.create_train_state(prng.PRNGKey(0), cfg, device="cpu")
    a, b = texp.freeze(state, cfg), texp.freeze(state.params, cfg)
    assert all(torch.equal(x.w, y.w) for x, y in zip(a.layers, b.layers))
    jcfg = jpaper.get("mlp1", scale=SCALE)
    jfm = jexp.freeze(jles.create_train_state(jax.random.PRNGKey(0), jcfg), jcfg)
    for lt, lj in zip(a.layers, jfm.layers):
        _eq(lt.w, lj.w)
