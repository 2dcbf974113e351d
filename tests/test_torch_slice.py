"""PyTorch port, the serving slice end to end, held against the JAX package.

Weights cross over two ways — a JAX parameter tree as numpy arrays
(``params_from_numpy``) and a JAX ``save_frozen`` directory
(``load_frozen``) — and the port's unfused oracle, plan, engine and CLI
must give JAX's logits and labels exactly, dtype included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import model as JM
from repro.infer import compile_plan as j_compile_plan
from repro.infer import freeze as j_freeze
from repro.infer import save_frozen as j_save_frozen
from repro.serving.vision import VisionEngine as JVisionEngine
from repro_torch.configs import paper as tpaper
from repro_torch.core import model as TM
from repro_torch.core import prng
from repro_torch.infer import compile_plan, freeze, load_frozen
from repro_torch.launch import serve_vision
from repro_torch.serving import VisionEngine


def _jax_params(arch="vgg8b", scale=0.0625, seed=0):
    jcfg = jpaper.get(arch, scale=scale)
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, jax.tree_util.tree_map(np.asarray, params)


def _images(n, shape, seed=0):
    return np.random.default_rng(seed).integers(-127, 128, (n, *shape)).astype(np.int32)


def _eq(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    got = t.cpu().numpy()
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    np.testing.assert_array_equal(got, j)


@pytest.fixture(scope="module")
def small():
    """VGG8B at scale 1/16: JAX config, JAX params, and the params as numpy."""
    return _jax_params()


def test_params_from_numpy_frozen_forward_matches(small):
    jcfg, jparams, np_tree = small
    params = TM.params_from_numpy(np_tree, device="cpu")
    cfg = tpaper.get("vgg8b", scale=0.0625)
    x = _images(4, cfg.input_shape)
    _eq(TM.frozen_forward(params, cfg, x), JM.frozen_forward(jparams, jcfg, jnp.asarray(x)))
    _eq(TM.predict(params, cfg, x), JM.predict(jparams, jcfg, jnp.asarray(x)))


def test_init_params_tree_shape_matches_jax(small):
    _, _, np_tree = small
    cfg = tpaper.get("vgg8b", scale=0.0625)
    tparams = TM.init_params(prng.PRNGKey(0), cfg, device="cpu")
    assert len(tparams["blocks"]) == len(np_tree["blocks"])
    for tb, jb in zip(tparams["blocks"], np_tree["blocks"]):
        for part in ("fw", "lr"):
            assert tuple(tb[part]["w"].shape) == jb[part]["w"].shape
            assert tb[part]["w"].dtype == torch.int32
    assert tuple(tparams["output"]["w"].shape) == np_tree["output"]["w"].shape


def test_freeze_matches_jax(small):
    jcfg, jparams, np_tree = small
    cfg = tpaper.get("vgg8b", scale=0.0625)
    fm = freeze(TM.params_from_numpy(np_tree, device="cpu"), cfg)
    jfm = j_freeze(jparams, jcfg)
    assert fm.input_shape == jfm.input_shape and fm.num_bytes() == jfm.num_bytes()
    for t, j in zip(fm.layers, jfm.layers):
        assert (t.kind, t.sf, t.alpha_inv, t.apply_relu, t.pool) == \
            (j.kind, j.sf, j.alpha_inv, j.apply_relu, j.pool)
        _eq(t.w, j.w)


def test_load_frozen_plan_matches_jax_interpret(small, tmp_path):
    """JAX save_frozen → port load_frozen → plan ≡ JAX plan (Pallas, interpret)."""
    jcfg, jparams, _ = small
    jfm = j_freeze(jparams, jcfg)
    j_save_frozen(str(tmp_path), jfm)
    fm = load_frozen(str(tmp_path))
    plan = compile_plan(fm, device="cpu")
    jplan = j_compile_plan(jfm, backend="interpret")
    x = _images(3, fm.input_shape, seed=1)
    _eq(plan.logits(x), jplan.logits(jnp.asarray(x)))
    _eq(plan.predict(x), jplan.predict(jnp.asarray(x)))
    assert plan.summary() == jplan.summary()
    assert plan.metas == tuple(tuple(m) for m in jplan.metas)
    mat = compile_plan(fm, device="cpu", conv_mode="materialise", operand_dtype="int32")
    _eq(mat.logits(x), jplan.logits(jnp.asarray(x)))


def test_load_frozen_int16_weights_lift(tmp_path):
    """A trained export may hold int16 weights: the int32 operand path."""
    jcfg, jparams, _ = _jax_params(seed=3)
    w = jparams["blocks"][2]["fw"]["w"]
    jparams["blocks"][2]["fw"]["w"] = w.at[0, 0, 0, 0].set(300)
    jfm = j_freeze(jparams, jcfg)
    assert jfm.layers[2].w.dtype == jnp.int16
    j_save_frozen(str(tmp_path), jfm)
    fm = load_frozen(str(tmp_path))
    assert fm.layers[2].w.dtype == torch.int16
    plan = compile_plan(fm, device="cpu")
    jplan = j_compile_plan(jfm, backend="reference")
    assert plan.metas[2].operand_dtype == "int32"
    x = _images(2, fm.input_shape, seed=2)
    _eq(plan.logits(x), jplan.logits(jnp.asarray(x)))
    assert plan.summary() == jplan.summary()
    with pytest.raises(ValueError, match="not a frozen NITRO model"):
        from repro.train import checkpoint as jckpt
        jckpt.save(str(tmp_path / "other"), 0, [{"w": np.zeros(2, np.int8)}],
                   extra={"format": "x"})
        load_frozen(str(tmp_path / "other"))


def test_engine_labels_match_jax(small):
    jcfg, jparams, np_tree = small
    cfg = tpaper.get("vgg8b", scale=0.0625)
    fm = freeze(TM.params_from_numpy(np_tree, device="cpu"), cfg)
    images = list(_images(11, cfg.input_shape, seed=4))
    with VisionEngine(compile_plan(fm, device="cpu"), batch_size=4,
                      max_wait_ms=1.0) as eng:
        futs = [eng.submit(im) for im in images]
        results = [f.result(timeout=60) for f in futs]
        snap = eng.stats.snapshot()
    jplan = j_compile_plan(j_freeze(jparams, jcfg), backend="reference")
    with JVisionEngine(jplan, batch_size=4, max_wait_ms=1.0) as jeng:
        jlabels = jeng.classify(images)
    assert [r.label for r in results] == jlabels
    for r, im in zip(results, images):
        _eq(torch.from_numpy(r.logits), jplan.logits(jnp.asarray(im[None]))[0])
    assert snap["requests"] == 11 and snap["padded_slots"] == 4 * snap["batches"] - 11
    assert set(snap) == {"requests", "batches", "padded_slots", "avg_batch_fill",
                         "batch_latency_ms"}


def test_full_width_vgg8b_plan_matches_jax():
    """Full-width VGG8B (scale 1), batch 2: port plan ≡ JAX reference plan."""
    jcfg, jparams, np_tree = _jax_params(scale=1.0, seed=7)
    cfg = tpaper.get("vgg8b", scale=1.0)
    fm = freeze(TM.params_from_numpy(np_tree, device="cpu"), cfg)
    plan = compile_plan(fm, device="cpu")
    jplan = j_compile_plan(j_freeze(jparams, jcfg), backend="reference")
    x = _images(2, cfg.input_shape, seed=8)
    _eq(plan.logits(x), jplan.logits(jnp.asarray(x)))
    assert plan.summary() == jplan.summary()
    assert [m.operand_dtype for m in plan.metas] == ["int32"] + ["int8"] * 7


def test_cli_runs_on_cpu(capsys):
    res = serve_vision.main(["--device", "cpu", "--scale", "0.0625",
                             "--requests", "8", "--batch", "4",
                             "--scheduler", "static"])
    assert len(res["results"]) == 8 and res["snapshot"]["fleet"]["requests"] == 8
    images = np.stack(res["images"])
    # the JAX launcher's request stream: one default_rng(seed) draw per image
    rng = np.random.default_rng(0)
    want = np.stack([rng.integers(-127, 128, (32, 32, 3)).astype(np.int32)
                     for _ in range(8)])
    np.testing.assert_array_equal(images, want)
    labels = res["plan"].predict(images).numpy().tolist()
    assert [r.label for r in res["results"]] == labels
    assert "[serve] scheduler=static 8 requests" in capsys.readouterr().out
    # the default scheduler is the continuous FleetEngine: same requests,
    # same labels
    cont = serve_vision.main(["--device", "cpu", "--scale", "0.0625",
                              "--requests", "8", "--batch", "4"])
    np.testing.assert_array_equal(np.stack(cont["images"]), want)
    assert [r.label for r in cont["results"]] == labels
    assert cont["snapshot"]["models"]["default"]["requests"] == 8
    assert "[serve] scheduler=continuous 8 requests" in capsys.readouterr().out
