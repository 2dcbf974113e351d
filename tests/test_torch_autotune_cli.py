"""PyTorch port, ``--autotune`` / ``--autotune-cache`` in the train and
serve CLIs, held against the JAX launchers on the CPU.

  * the train CLI with ``--autotune`` at vgg8b 1/16 width, 2 steps: it
    tunes every problem of ``training_shapes`` (the plain stream convs'
    band heights) into the cache, its final state (checkpoint) and its
    ``metrics.jsonl`` are byte for byte those of the JAX launcher's
    ``--autotune`` run on the same tiles (the port's winners, written
    under JAX's fingerprint, so the JAX run measures nothing); a second
    run with the same cache measures nothing, is bitwise the first and
    counts its lookups on the run's registry;
  * under ``--num-devices 2`` rank 0 looks the global batch's problems up
    in the first run's cache (measuring and adding nothing: the ranks'
    batch would have missed every one), both ranks configure the file
    after a barrier, and the run is the single-device run bitwise;
  * the serve CLI with ``--autotune``: every request's logits and label
    are the JAX plan's under the same cache, a second run measures
    nothing, and ``/metrics`` carries the hits, the misses and one
    ``kernel_int8_path_active`` sample per plan step.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.infer.plan import compile_plan as jcompile_plan
from repro.kernels import autotune as jat
from repro.launch import serve_vision as jserve
from repro.launch import train as jtrain
from repro_torch.kernels import autotune as at
from repro_torch.kernels.autotune import search
from repro_torch.launch import serve_vision
from repro_torch.launch import train as ttrain
from repro_torch.train import checkpoint as tckpt

SCALE = 0.0625
TRAIN_KW = dict(steps=2, batch=4, scale=SCALE, telemetry_every=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: the suite runs six
    workers on the host's cores, and the plain versions' many small
    integer ops slow down several times over when each worker also
    fans out to every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_process_cache():
    for mod in (at, jat):
        mod.configure(None)
        mod.set_metrics(None)
    yield
    for mod in (at, jat):
        mod.configure(None)
        mod.set_metrics(None)


def _as_jax_cache(port_path, jax_path) -> dict:
    """The port's cache entries under the JAX package's fingerprint."""
    entries = json.loads(open(port_path).read())["entries"]
    with open(jax_path, "w") as f:
        json.dump({"fingerprint": jat.build_fingerprint(), "entries": entries}, f)
    return entries


class _Spy:
    """Records every ``search.tune`` call's outcome."""

    def __init__(self, monkeypatch):
        self.outcomes = []
        orig = search.tune

        def spy(*a, **kw):
            out = orig(*a, **kw)
            self.outcomes.append(out)
            return out

        monkeypatch.setattr(search, "tune", spy)

    @property
    def measured(self) -> bool:
        return any(out != (None, {}) for out in self.outcomes)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The port's cold ``--autotune`` run and the JAX launcher's
    ``--autotune`` run on the port's winners."""
    d = tmp_path_factory.mktemp("autotune_train")
    tuned = ttrain.train_nitro("vgg8b", device="cpu", ckpt_dir=str(d / "port"),
                               telemetry_out=str(d / "port.jsonl"), autotune=True,
                               autotune_cache=str(d / "port_cache.json"), **TRAIN_KW)
    at.configure(None)
    at.set_metrics(None)
    entries = _as_jax_cache(d / "port_cache.json", d / "jax_cache.json")
    want = jtrain.train_nitro("vgg8b", ckpt_dir=str(d / "jax"), dataset="tiles32",
                              telemetry_out=str(d / "jax.jsonl"), autotune=True,
                              autotune_cache=str(d / "jax_cache.json"), **TRAIN_KW)
    jat.configure(None)
    jat.set_metrics(None)
    return d, tuned, want, entries


def test_train_cli_autotune_tunes_jaxs_problems(train_runs):
    d, _, _, entries = train_runs
    cfg = ttrain.get_paper_config("vgg8b", scale=SCALE)
    want = sorted(at.cache_key(p["op"], p["shape"], p["dtype"], "reference",
                               p["conv_mode"], p["fuse_bwd"])
                  for p in at.training_shapes(cfg, TRAIN_KW["batch"])
                  if p["op"].startswith("conv"))
    assert sorted(entries) == want and len(want) == 18
    # the JAX run found every key and measured nothing: its file is unchanged
    jentries = json.loads((d / "jax_cache.json").read_text())["entries"]
    assert jentries == entries


def test_train_cli_autotune_state_and_metrics_are_jaxs(train_runs):
    d, tuned, want, _ = train_runs
    assert (d / "port.jsonl").read_bytes() == (d / "jax.jsonl").read_bytes()
    assert tuned["test_accuracy"] == want["test_accuracy"]
    assert tuned["scaled_loss"] == want["scaled_loss"]
    step = tckpt.latest_step(str(d / "jax"))
    assert tckpt.latest_step(str(d / "port")) == step == 2
    paths = [e["path"] for e in tckpt.read_manifest(str(d / "jax"), step)["leaves"]]
    tarrs, _ = tckpt.restore_leaves(str(d / "port"), paths)
    jarrs, _ = tckpt.restore_leaves(str(d / "jax"), paths)
    for a, b in zip(tarrs, jarrs, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_train_cli_second_run_measures_nothing(train_runs, monkeypatch, capsys, tmp_path):
    d, tuned, _, entries = train_runs
    spy = _Spy(monkeypatch)
    res = ttrain.main(["--arch", "vgg8b", "--steps", "2", "--batch", "4", "--scale",
                       str(SCALE), "--device", "cpu", "--autotune", "--autotune-cache",
                       str(d / "port_cache.json"), "--telemetry-every", "1",
                       "--telemetry-out", str(tmp_path / "again.jsonl"),
                       "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert f"[autotune] 18 problems tuned/cached -> {d / 'port_cache.json'}" in out
    assert spy.outcomes and not spy.measured  # only the knobless matmuls reach tune()
    assert json.loads((d / "port_cache.json").read_text())["entries"] == entries
    assert (tmp_path / "again.jsonl").read_bytes() == (d / "port.jsonl").read_bytes()
    for (_, a), (_, b) in zip(tckpt.flatten_with_paths(res["state"]),
                              tckpt.flatten_with_paths(tuned["state"]), strict=True):
        assert torch.equal(a, b)
    # the lookups were counted on the run's registry: every tuned conv key a
    # hit, each knobless problem a miss, once per key
    hits, misses = (family.value for family in at.state._metrics[:2])
    assert hits == 12  # the six convs' forward and grad_W (the step computes no grad_x)
    assert misses > 0


def test_train_cli_autotune_under_data_parallelism(train_runs, tmp_path, capfd, monkeypatch):
    d, tuned, _, entries = train_runs
    cache = tmp_path / "dp_cache.json"
    shutil.copy(d / "port_cache.json", cache)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each spawned rank takes one core
    res = ttrain.main(["--arch", "vgg8b", "--steps", "2", "--batch", "4", "--scale",
                       str(SCALE), "--device", "cpu", "--num-devices", "2", "--autotune",
                       "--autotune-cache", str(cache)])
    out = capfd.readouterr().out  # rank 0 prints from its own process
    assert f"[autotune] 18 problems tuned/cached -> {cache}" in out
    # rank 0 looked up the global batch's problems, all cached: at the
    # ranks' batch of 2 it would have tuned and added 18 more
    assert json.loads(cache.read_text())["entries"] == entries
    assert all("|4x" in k for k in entries)
    for (_, a), (_, b) in zip(tckpt.flatten_with_paths(res["state"]),
                              tckpt.flatten_with_paths(tuned["state"]), strict=True):
        assert torch.equal(a, b)


SERVE_ARGV = ["--device", "cpu", "--scale", str(SCALE), "--requests", "10", "--batch", "4",
              "--autotune", "--metrics-port", "0"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("autotune_serve")
    res = serve_vision.main(SERVE_ARGV + ["--autotune-cache", str(d / "cache.json")])
    at.configure(None)
    at.set_metrics(None)
    return d, res


def test_serve_cli_autotune_predictions_are_jaxs(served):
    d, res = served
    entries = _as_jax_cache(d / "cache.json", d / "jax_cache.json")
    assert len(entries) == 6 and all(k.startswith("conv|4x") for k in entries)
    jfm, _ = jserve._train_and_freeze("vgg8b", SCALE, 0, 64, 0)
    jat.configure(str(d / "jax_cache.json"))
    jplan = jcompile_plan(jfm, backend="reference")
    assert jat.tune_plan(jplan, 4, cache=jat.active_cache()) == {
        k: jat.TileConfig.from_json(v) for k, v in entries.items()}
    images = np.stack(res["images"])
    n = len(images)
    padded = np.concatenate([images, np.zeros((-n % 4, *images.shape[1:]), images.dtype)])
    want = np.concatenate([np.asarray(jplan.logits(jnp.asarray(padded[i:i + 4])))
                           for i in range(0, len(padded), 4)])[:n]  # one batch shape: one jit
    got = np.stack([r.logits for r in res["results"]])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert [r.label for r in res["results"]] == want.argmax(-1).tolist()


def test_serve_cli_autotune_metrics(served):
    _, res = served
    snap = res["metrics"].json_snapshot()
    plan = res["plan"]
    gauge = {s["labels"]["layer"]: s["value"]
             for s in snap["kernel_int8_path_active"]["samples"]}
    assert gauge == {f"{plan.name}/{i}": int(m.operand_dtype == "int8")
                     for i, m in enumerate(plan.metas)}
    # the padded batch of 4: six tuned conv keys hit, the two matmuls miss
    assert snap["kernel_tile_cache_hits_total"]["samples"][0]["value"] == 6
    assert snap["kernel_tile_cache_misses_total"]["samples"][0]["value"] == 2


def test_serve_cli_second_run_measures_nothing(served, monkeypatch, capsys):
    d, res = served
    spy = _Spy(monkeypatch)
    again = serve_vision.main(SERVE_ARGV + ["--autotune-cache", str(d / "cache.json")])
    assert "[autotune] 6 problems tuned/cached" in capsys.readouterr().out
    assert spy.outcomes and not spy.measured
    assert [r.label for r in again["results"]] == [r.label for r in res["results"]]
