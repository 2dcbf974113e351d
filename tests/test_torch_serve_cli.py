"""PyTorch port, the serve CLI's control plane held against the JAX
launcher (``repro.launch.serve_vision``), on the CPU.

  * ``_train_and_freeze`` (and ``--train-steps`` / ``--export-dir``)
    gives the JAX launcher's weights bitwise;
  * ``--split`` over repeatable ``--model-dir NAME=PATH`` (directories of
    either package) routes every request as JAX's ``Router`` does, and
    each label is the answering arm's plan's;
  * ``--fleet-dir`` serves a ``FLEET.json`` with its split, ``--slo``
    attributes every request;
  * every route / split / flag error exits with the JAX launcher's
    message;
  * ``examples_torch/serve_cifar.py`` runs its self-checking lifecycle.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import model as JM
from repro.infer import export as jexp
from repro.launch import serve_vision as jserve
from repro.serving import Router as JRouter
from repro.serving import parse_split as j_parse_split
from repro_torch.infer import compile_plan, load_frozen, save_fleet_manifest
from repro_torch.launch import serve_vision

SCALE = "0.0625"


def _eq(t, j) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    np.testing.assert_array_equal(got, j)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """Two mlp1 arms at 1/16 width saved by the JAX package's save_frozen:
    ``{name: directory}``."""
    root = tmp_path_factory.mktemp("arms")
    jcfg = jpaper.get("mlp1", scale=float(SCALE))
    dirs = {}
    for name, seed in (("a", 0), ("b", 1)):
        fm = jexp.freeze(JM.init_params(jax.random.PRNGKey(seed), jcfg), jcfg)
        dirs[name] = str(root / name)
        jexp.save_frozen(dirs[name], fm)
    return dirs


def test_train_and_freeze_matches_jax(tmp_path, capsys):
    fm, ds = serve_vision._train_and_freeze("vgg8b", 0.0625, 2, 16, 0, device="cpu")
    jfm, jds = jserve._train_and_freeze("vgg8b", 0.0625, 2, 16, 0)
    np.testing.assert_array_equal(ds.x_train, jds.x_train)
    assert fm.input_shape == jfm.input_shape and fm.name == jfm.name
    for lt, lj in zip(fm.layers, jfm.layers, strict=True):
        assert (lt.kind, lt.sf, lt.alpha_inv, lt.apply_relu, lt.pool) == \
            (lj.kind, lj.sf, lj.alpha_inv, lj.apply_relu, lj.pool)
        _eq(lt.w, lj.w)
    out = capsys.readouterr().out
    assert "[train] step    0 loss=" in out
    # the CLI path: train, export, serve
    res = serve_vision.main(["--device", "cpu", "--scale", SCALE, "--train-steps", "2",
                             "--train-batch", "16", "--export-dir", str(tmp_path),
                             "--requests", "6", "--batch", "4"])
    exported = load_frozen(str(tmp_path))
    for lt, lj in zip(exported.layers, jfm.layers, strict=True):
        _eq(lt.w, lj.w)
    assert res["target"] == "default" and res["registry"].ids() == ["default"]
    assert "[export] frozen model -> " in capsys.readouterr().out


def test_split_routes_as_jax_router_and_labels_match_arm_plans(arms, capsys):
    res = serve_vision.main([
        "--device", "cpu", "--split", "a=0.9,b=0.1", "--model-dir", f"a={arms['a']}",
        "--model-dir", f"b={arms['b']}", "--requests", "48", "--batch", "8",
        "--slo", "60000"])
    assert res["target"] == "split"
    jrouter = JRouter({"split": j_parse_split("a=0.9,b=0.1")})
    routed = [res["router"].resolve(res["target"], r) for r in res["request_ids"]]
    assert routed == [jrouter.resolve("split", r) for r in res["request_ids"]]
    assert set(routed) == {"a", "b"}
    plans = {m: compile_plan(load_frozen(d), device="cpu") for m, d in arms.items()}
    for arm, img, r in zip(routed, res["images"], res["results"]):
        want = plans[arm].logits(img[None]).numpy()[0]
        np.testing.assert_array_equal(r.logits, want)
        assert r.label == int(plans[arm].predict(img[None])[0])
    snap = res["snapshot"]
    assert {m: s["requests"] for m, s in snap["models"].items()} == \
        {"a": routed.count("a"), "b": routed.count("b")}
    assert sum(s["requests"] for s in snap["slo"].values()) == 48
    out = capsys.readouterr().out
    assert "[serve] scheduler=continuous 48 requests" in out
    assert "[slo]   a: 0/" in out and "[slo]   b: 0/" in out
    assert f"[load] a (mlp1) <- {arms['a']}" in out


def test_fleet_dir_serves_its_split(arms, tmp_path, capsys):
    save_fleet_manifest(str(tmp_path), dict(arms), splits={"ab": {"a": 1.0, "b": 1.0}})
    res = serve_vision.main(["--device", "cpu", "--fleet-dir", str(tmp_path),
                             "--requests", "16", "--batch", "4"])
    assert res["target"] == "ab"
    jrouter = JRouter({"ab": {"a": 1.0, "b": 1.0}})
    assert [res["router"].resolve("ab", r) for r in res["request_ids"]] == \
        [jrouter.resolve("ab", r) for r in res["request_ids"]]
    assert res["batches_total"] >= 2 + res["snapshot"]["fleet"]["batches"]
    assert f"[load] a <- {arms['a']}" in capsys.readouterr().out


def _jax_exit(argv, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", ["serve_vision", "--backend", "reference", *argv])
    with pytest.raises(SystemExit) as e:
        jserve.main()
    return str(e.value)


def _fleet(arms, root, splits):
    save_fleet_manifest(str(root), dict(arms), splits=splits)
    return ["--fleet-dir", str(root)]


ERRORS = {
    "unknown route": lambda a, r: ["--model-dir", f"a={a['a']}", "--model-dir",
                                   f"b={a['b']}", "--route", "ghost"],
    "no route": lambda a, r: ["--model-dir", f"a={a['a']}", "--model-dir", f"b={a['b']}"],
    "split to unknown": lambda a, r: ["--model-dir", f"a={a['a']}", "--model-dir",
                                      f"b={a['b']}", "--split", "a=0.5,c=0.5"],
    "bad model dir": lambda a, r: ["--model-dir", "a="],
    "export with model dir": lambda a, r: ["--model-dir", a["a"], "--export-dir", str(r)],
    "fleet and model dir": lambda a, r: ["--fleet-dir", str(r), "--model-dir", a["a"]],
    "several aliases": lambda a, r: _fleet(a, r, {"s": {"a": 1.0}, "t": {"b": 1.0}}),
    "static with split": lambda a, r: ["--model-dir", f"a={a['a']}", "--split", "a=1",
                                       "--scheduler", "static"],
    "static with slo": lambda a, r: ["--model-dir", a["a"], "--scheduler", "static",
                                     "--slo", "5"],
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_cli_errors_match_jax(case, arms, tmp_path, monkeypatch):
    argv = ERRORS[case](arms, tmp_path)
    with pytest.raises(SystemExit) as e:
        serve_vision.main(["--device", "cpu", *argv])
    assert str(e.value) == _jax_exit(argv, monkeypatch)
    assert str(e.value)  # a message, not a bare exit code


def test_route_to_one_arm_and_static_scheduler(arms):
    res = serve_vision.main(["--device", "cpu", "--model-dir", f"a={arms['a']}",
                             "--model-dir", f"b={arms['b']}", "--route", "b",
                             "--requests", "5", "--batch", "4"])
    assert res["target"] == "b"
    assert res["snapshot"]["models"]["b"]["requests"] == 5
    assert res["snapshot"]["models"]["a"]["requests"] == 0
    static = serve_vision.main(["--device", "cpu", "--model-dir", arms["a"],
                                "--scheduler", "static", "--requests", "5",
                                "--batch", "4"])
    assert static["snapshot"]["models"] == {}
    assert static["snapshot"]["fleet"]["requests"] == 5
    plan = compile_plan(load_frozen(arms["a"]), device="cpu")
    assert [r.label for r in static["results"]] == \
        plan.predict(np.stack(static["images"])).tolist()


def test_serve_cifar_example_runs_on_cpu(capsys):
    """``examples_torch/serve_cifar.py`` checks itself: every served
    prediction equals its arm's ``model.predict``, and after the hot swap
    the candidate answers as prod."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples_torch" / "serve_cifar.py"
    spec = importlib.util.spec_from_file_location("serve_cifar_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--steps", "2", "--scale", SCALE, "--batch", "16",
                  "--serve-batch", "8", "--clients", "8"])
    out = capsys.readouterr().out
    assert "[parity] every answer bit-identical" in out
    assert "[swap] candidate -> final checkpoint (version 1)" in out
