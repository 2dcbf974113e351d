"""PyTorch port, checkpoints and the MLP archs of the train CLI ≡ the JAX
package's, bitwise, on the CPU.

Covers ``flatten_for_mlp`` (byte-identical arrays), the checkpoint leaf
order and path strings against ``jax.tree_util.tree_flatten_with_path``,
checkpoints crossing between the two packages both ways (then one more
step equal on both sides), the async writer's snapshot, and the train CLI
against ``repro.launch.train.train_nitro``: mlp1 and mlp4 trajectories
and a run resumed from ``--ckpt-dir``.  Tolerance zero, dtype included.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import les as jles
from repro.core import optimizer as jopt
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.train import checkpoint as jckpt
from repro_torch.configs import paper as tpaper
from repro_torch.core import les as tles
from repro_torch.core import prng
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.train import checkpoint as tckpt

SCALE = 0.0625
BATCH = 4


def _eq(t, j) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    assert got.shape == j.shape, (got.shape, j.shape)
    np.testing.assert_array_equal(got, j)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _states(arch, seed=0):
    tcfg, jcfg = tpaper.get(arch, scale=SCALE), jpaper.get(arch, scale=SCALE)
    ts = tles.create_train_state(prng.PRNGKey(seed), tcfg, device="cpu")
    js = jles.create_train_state(jax.random.PRNGKey(seed), jcfg)
    return tcfg, jcfg, ts, js


def _batch(cfg, it, seed=0):
    rng = np.random.default_rng(seed * 100 + it)
    x = rng.integers(-127, 128, (BATCH, *cfg.input_shape)).astype(np.int32)
    y = rng.integers(0, cfg.num_classes, BATCH).astype(np.int32)
    return x, y


def _assert_trees_eq(ttree, jtree) -> None:
    """Same leaf paths in the same order, every leaf bitwise equal."""
    tflat = tckpt.flatten_with_paths(ttree)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    assert [p for p, _ in tflat] == ["/".join(str(k) for k in p) for p, _ in jflat]
    for (_, a), (_, b) in zip(tflat, jflat, strict=True):
        _eq(a, b)


def _assert_ckpt_eq(tdir, jdir) -> None:
    """Two checkpoint directories hold the same step, paths, dtypes and
    arrays."""
    step = jckpt.latest_step(jdir)
    assert tckpt.latest_step(tdir) == step is not None
    tm, jm = tckpt.read_manifest(tdir, step), tckpt.read_manifest(jdir, step)
    strip = [{k: e[k] for k in ("path", "file", "shape", "dtype")} for e in jm["leaves"]]
    assert [{k: e[k] for k in ("path", "file", "shape", "dtype")}
            for e in tm["leaves"]] == strip
    paths = [e["path"] for e in jm["leaves"]]
    tarrs, _ = tckpt.restore_leaves(tdir, paths)
    jarrs, _ = tckpt.restore_leaves(jdir, paths)
    for a, b in zip(tarrs, jarrs, strict=True):
        _eq(a, b)


@pytest.mark.parametrize("dataset", ["tiles32", "digits28"])
def test_flatten_for_mlp_byte_identical(dataset):
    tds = tsyn.flatten_for_mlp(tsyn.make_image_dataset(dataset, n_train=64, n_test=16))
    jds = jsyn.flatten_for_mlp(jsyn.make_image_dataset(dataset, n_train=64, n_test=16))
    assert tds.input_shape == jds.input_shape and tds.num_classes == jds.num_classes
    for f in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(tds, f), getattr(jds, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["mlp1", "vgg8b"])
def test_flatten_paths_match_jax(arch):
    """The TrainState's leaves in JAX's order under JAX's path strings."""
    _, _, ts, js = _states(arch)
    _assert_trees_eq(ts, js)


@pytest.mark.parametrize("arch", ["mlp4", "vgg8b"])
def test_jax_checkpoint_restores_in_port_and_back(tmp_path, arch):
    """One JAX step, saved by JAX → restored by the port ≡ the JAX state;
    one more step on each side stays equal; the port's save of that state
    restores in JAX ≡ JAX's own state, and one more step from there on
    each side stays equal too."""
    tcfg, jcfg, ts0, js = _states(arch, seed=3)
    jstep = jax.jit(functools.partial(jles.train_step, cfg=jcfg, backend="reference"))
    x, y = _batch(tcfg, 0, seed=3)
    js, _ = jstep(js, x=jnp.asarray(x), labels=jnp.asarray(y), key=jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path / "jax"), 1, js)
    ts, step = tckpt.restore(str(tmp_path / "jax"), ts0)
    assert step == 1
    _assert_trees_eq(ts, js)
    x, y = _batch(tcfg, 1, seed=3)
    ts, tm = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(1))
    js, jm = jstep(js, x=jnp.asarray(x), labels=jnp.asarray(y), key=jax.random.PRNGKey(1))
    _eq(tm.loss, jm.loss)
    _assert_trees_eq(ts, js)
    tckpt.save(str(tmp_path / "port"), 2, ts)
    back, step = jckpt.restore(str(tmp_path / "port"), js)
    assert step == 2
    _assert_trees_eq(ts, back)
    jckpt.save(str(tmp_path / "jax"), 2, js)
    _assert_ckpt_eq(str(tmp_path / "port"), str(tmp_path / "jax"))
    x, y = _batch(tcfg, 2, seed=3)
    ts, tm = tles.train_step(ts, tcfg, _t(x), _t(y), prng.PRNGKey(2))
    back, jm = jstep(back, x=jnp.asarray(x), labels=jnp.asarray(y),
                     key=jax.random.PRNGKey(2))
    _eq(tm.loss, jm.loss)
    _assert_trees_eq(ts, back)


def test_async_checkpointer_snapshots_before_writing(tmp_path):
    """The tree is copied to the host before the writer thread starts, so
    a later in-place change does not reach the file; one save at a time."""
    _, _, ts, _ = _states("mlp1")
    w = ts.params["blocks"][0]["fw"]["w"]
    before = w.clone()
    saver = tckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(5, ts)
    w.add_(1)  # the caller moves on and changes its tensors
    saver.save(6, ts)  # waits for the first save, then snapshots again
    saver.wait()
    assert tckpt.latest_step(str(tmp_path)) == 6
    old, _ = tckpt.restore(str(tmp_path), ts, step=5)
    new, _ = tckpt.restore(str(tmp_path), ts, step=6)
    assert torch.equal(old.params["blocks"][0]["fw"]["w"], before)
    assert torch.equal(new.params["blocks"][0]["fw"]["w"], w)
    assert old.step.dtype == torch.int32 and old.step.shape == ()


def test_partial_checkpoint_is_refused(tmp_path):
    _, _, ts, _ = _states("mlp1")
    path = tckpt.save(str(tmp_path), 3, ts)
    manifest = os.path.join(path, "MANIFEST.json")
    with open(manifest) as f:
        text = f.read()
    with open(manifest, "w") as f:
        f.write(text.replace('"COMPLETE"', '"PARTIAL"'))
    assert tckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path), ts)
    with pytest.raises(ValueError, match="partial"):
        tckpt.restore(str(tmp_path), ts, step=3)


@pytest.mark.parametrize("arch,dataset,scale", [
    ("mlp1", "digits28", 1.0), ("mlp1", "tiles32", 0.25), ("mlp4", "tiles32", SCALE),
])
def test_train_nitro_mlp_matches_jax(tmp_path, capsys, arch, dataset, scale):
    """The CLI's MLP run on the CPU: the JAX trainer's progress lines, test
    accuracy and scaled loss, and a final state equal to the one the JAX
    trainer checkpoints."""
    got = ttrain.train_nitro(arch, steps=3, batch=8, dataset=dataset, scale=scale,
                             device="cpu", ckpt_dir=str(tmp_path / "port"))
    tout = capsys.readouterr().out
    want = jtrain.train_nitro(arch, steps=3, batch=8, ckpt_dir=str(tmp_path / "jax"),
                              dataset=dataset, scale=scale)
    jout = capsys.readouterr().out
    assert got["steps"] == want["steps"] == 3
    assert got["test_accuracy"] == want["test_accuracy"]
    assert got["scaled_loss"] == want["scaled_loss"]
    for line in ("step     0", "[done] test accuracy"):
        t_line = next(ln for ln in tout.splitlines() if ln.startswith(line))
        j_line = next(ln for ln in jout.splitlines() if ln.startswith(line))
        assert t_line == j_line
    jstate, _ = jckpt.restore(str(tmp_path / "jax"), _jax_template(got["state"]))
    _assert_trees_eq(got["state"], jstate)
    _assert_ckpt_eq(str(tmp_path / "port"), str(tmp_path / "jax"))


def _jax_template(tstate):
    """A JAX TrainState shaped like the port's (restore fills it in)."""
    def leaf(t):
        return np.zeros(tuple(t.shape), np.int32)
    p = tstate.params
    return jles.TrainState(
        params={"blocks": [{"fw": {"w": leaf(b["fw"]["w"])}, "lr": {"w": leaf(b["lr"]["w"])}}
                           for b in p["blocks"]],
                "output": {"w": leaf(p["output"]["w"])}},
        opt_lr=jopt.IntegerSGDState(leaf(tstate.opt_lr.gamma_inv),
                                    leaf(tstate.opt_lr.eta_inv)),
        opt_fw=jopt.IntegerSGDState(leaf(tstate.opt_fw.gamma_inv),
                                    leaf(tstate.opt_fw.eta_inv)),
        step=leaf(tstate.step),
    )


def test_resumed_cli_run_matches_jax(tmp_path, capsys):
    """Two CLI calls of 2 steps with one --ckpt-dir: the second resumes
    from step 2 ('[restore] resumed from step 2'), keys PRNGKey(2 + it)
    with batches shuffled from seed 0 again (the JAX launcher's way), and
    every checkpoint and result equals the JAX launcher's two calls."""
    argv = ["--arch", "vgg8b", "--steps", "2", "--batch", "8", "--scale", str(SCALE),
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "port")]
    first = ttrain.main(argv)
    capsys.readouterr()
    second = ttrain.main(argv)
    tout = capsys.readouterr().out
    assert first["start_step"] == 0 and second["start_step"] == 2
    assert second["steps"] == 2 and int(second["state"].step) == 4
    assert "[restore] resumed from step 2" in tout.splitlines()
    kw = dict(steps=2, batch=8, ckpt_dir=str(tmp_path / "jax"), dataset="tiles32",
              scale=SCALE)
    jtrain.train_nitro("vgg8b", **kw)
    capsys.readouterr()
    want = jtrain.train_nitro("vgg8b", **kw)
    jout = capsys.readouterr().out
    assert "[restore] resumed from step 2" in jout.splitlines()
    assert second["test_accuracy"] == want["test_accuracy"]
    assert second["scaled_loss"] == want["scaled_loss"]
    assert want["steps"] == second["steps"]
    _assert_ckpt_eq(str(tmp_path / "port"), str(tmp_path / "jax"))
    # the same sequence on the port's plain path from a fresh directory
    # reproduces itself (the resume is deterministic)
    again = [ttrain.main(argv[:-1] + [str(tmp_path / "again")]) for _ in range(2)]
    capsys.readouterr()
    for (p, a), (q, b) in zip(tckpt.flatten_with_paths(again[1]["state"]),
                              tckpt.flatten_with_paths(second["state"]), strict=True):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b)
