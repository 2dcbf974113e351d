"""PyTorch port, the kernel autotuner (``repro_torch.kernels.autotune``)
held against the JAX package's (``repro.kernels.autotune``) on the CPU.

  * ``TileConfig`` reads and writes the JAX package's dicts, and the
    candidate space: the plain stream conv's band heights;
  * ``cache_key`` strings and the ``plan_shapes`` / ``training_shapes``
    problem lists are JAX's, letter for letter, on a tiny config, vgg8b
    vgg11b and mlp4 at 1/16 width;
  * the cache: round trip, corrupt file, other fingerprint, concurrent
    writers as threads and as processes, no entry lost;
  * ``resolve_tiles``: JAX's hit/miss counts, each key counted once until
    the next ``configure``, nothing built without a cache; the
    ``kernel_int8_path_active`` gauge of a frozen vgg8b plan at
    ``digits28`` is JAX's;
  * a plan looks up the keys the JAX plan looks up (the frozen weight's
    dtype, a materialise miss falling through to the inner matmul);
  * ``tune``: parity-gated, the winner no slower than the default in its
    session, the untunable combinations ``(None, {})`` (every op on
    ``cuda``), ``tune_plan`` a second time measures nothing, the
    ``fuse_opt`` lookups miss after tuning as JAX's do;
  * every dispatcher takes ``tiles=``, and the plain convs and
    ``conv_grads`` under any band height equal JAX's (hypothesis).

Tolerance zero, dtypes compared; inputs from ``numpy`` with a seed.
"""

import inspect
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_paper_config as jget_config
from repro.infer.export import load_frozen as jload_frozen
from repro.infer.plan import compile_plan as jcompile_plan
from repro.kernels import autotune as jat
from repro.kernels.grad_ops import conv_grads as jconv_grads
from repro.kernels.nitro_conv.ops import fused_conv as jfused_conv
from repro.kernels.nitro_conv.ops import fused_conv_fwd as jfused_conv_fwd
from repro.obs.metrics import MetricRegistry as JMetricRegistry
from repro_torch.configs import get_paper_config
from repro_torch.core import model as M
from repro_torch.core import prng
from repro_torch.core.scaling import conv_scale_factor, linear_scale_factor
from repro_torch.infer import compile_plan, freeze, save_frozen
from repro_torch.kernels import autotune as at
from repro_torch.kernels import grad_ops
from repro_torch.kernels.autotune import search, state
from repro_torch.kernels.nitro_conv import ops as conv_ops
from repro_torch.kernels.nitro_matmul import ops as mm_ops
from repro_torch.obs.metrics import MetricRegistry

ROOT = Path(__file__).resolve().parents[1]


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
    """No test sees (or leaks) a process-wide autotune state, in either
    package."""
    for mod in (at, jat):
        mod.configure(None)
        mod.set_metrics(None)
    yield
    for mod in (at, jat):
        mod.configure(None)
        mod.set_metrics(None)


def _ints(shape, lo=-63, hi=64, seed=0, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _eq(t, j) -> None:
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert got.dtype == j.dtype, (got.dtype, j.dtype)
    np.testing.assert_array_equal(got, j)


def _tiny_cfgs():
    """The JAX suite's tiny smoke topology in both packages."""
    from repro.core.blocks import BlockSpec as JBlockSpec
    from repro.core.model import NitroConfig as JNitroConfig
    from repro_torch.core.blocks import BlockSpec
    from repro_torch.core.model import NitroConfig

    def make(spec, config):
        return config(blocks=(spec("conv", 8, pool=True, d_lr=64), spec("linear", 16)),
                      input_shape=(8, 8, 3), num_classes=10, gamma_inv=512,
                      name="tiny-smoke")
    return make(BlockSpec, NitroConfig), make(JBlockSpec, JNitroConfig)


def _cfgs(name):
    """(port config, JAX config) for a problem-list case."""
    if name == "tiny":
        return _tiny_cfgs()
    arch, scale = {"vgg8b": ("vgg8b", 0.0625), "vgg11b": ("vgg11b", 0.0625),
                   "mlp4": ("mlp4", 0.0625)}[name]
    return get_paper_config(arch, scale=scale), jget_config(arch, scale=scale)


def _frozen(name, root, input_shape=None):
    """The port's frozen model of a seeded init and the same model in the
    JAX package (through the shared ``save_frozen`` format)."""
    cfg = (_cfgs(name)[0] if input_shape is None
           else get_paper_config(name, scale=0.0625, input_shape=input_shape))
    fm = freeze(M.init_params(prng.PRNGKey(0), cfg, device="cpu"), cfg)
    save_frozen(str(root), fm)
    return fm, jload_frozen(str(root))


# ---------------------------------------------------------------------------
# TileConfig and the candidate spaces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    at.TileConfig(), at.TileConfig(bm=32, bn=256, bk=512, bh=4, bf=256),
    at.TileConfig(bh=3), at.TileConfig(bm=1, bn=1, bk=1, bh=1, bf=1),
])
def test_tile_config_json_round_trip(cfg):
    assert at.TileConfig.from_json(cfg.to_json()) == cfg
    assert at.TileConfig.from_json(json.loads(json.dumps(cfg.to_json()))) == cfg


def test_tile_config_dicts_are_jax_dicts():
    jcfg = jat.TileConfig(bm=64, bh=4)
    assert at.TileConfig(bm=64, bh=4).to_json() == jcfg.to_json()
    assert at.TileConfig.from_json(jcfg.to_json()) == at.TileConfig(bm=64, bh=4)
    assert jat.TileConfig.from_json(at.TileConfig(bh=4).to_json()) == jat.TileConfig(bh=4)
    assert at.DEFAULT_TILES.to_json() == jat.DEFAULT_TILES.to_json()


def test_tile_config_from_json_checks_fields():
    assert at.TileConfig.from_json({"bm": 64, "future_knob": 7}) == at.TileConfig(bm=64)
    assert at.TileConfig.from_json({"splits": 0}) == at.DEFAULT_TILES
    for bad in ({"bm": 0}, {"bh": -1}, {"bf": 0}):
        with pytest.raises(ValueError):
            at.TileConfig.from_json(bad)


def test_jax_written_cache_entry_reads_into_the_same_fields(tmp_path):
    path = tmp_path / "jax.json"
    jat.TileCache(str(path)).put("k", jat.TileConfig(bm=32, bh=4, bf=256))
    payload = json.loads(path.read_text())
    got = at.TileConfig.from_json(payload["entries"]["k"])
    assert got == at.TileConfig(bm=32, bh=4, bf=256)
    # the same entry under the port's fingerprint is read by the port's cache
    payload["fingerprint"] = at.build_fingerprint("cpu")
    path.write_text(json.dumps(payload))
    assert at.TileCache(str(path), device="cpu").get("k") == got


@pytest.mark.parametrize("h,w,c,k,f", [(8, 8, 3, 3, 8), (32, 32, 3, 3, 128),
                                       (4, 4, 32, 3, 32), (16, 16, 16, 5, 256)])
def test_conv_candidates_cover_jax_reference_bands(h, w, c, k, f):
    got = at.conv_candidates(h, w, c, k, f)
    assert got[0] == at.DEFAULT_TILES and len(set(got)) == len(got)
    want = {cfg.bh for cfg in jat.conv_candidates(h, w, c, k, f)}
    assert want <= {cfg.bh for cfg in got}
    assert at.matmul_candidates(64, 2048, 1024) == [at.DEFAULT_TILES]


# ---------------------------------------------------------------------------
# The timing harness
# ---------------------------------------------------------------------------


def test_time_paired_runs_abba_rounds_after_one_warm_up_each():
    calls = []
    fns = {name: (lambda name=name: calls.append(name)) for name in "abc"}
    best = at.time_paired(fns, iters=4)
    assert calls == list("abc") + list("abc") + list("cba") + list("abc") + list("cba")
    assert set(best) == set(fns) and all(0 <= us < 1e6 for us in best.values())


def test_time_paired_keeps_each_variants_minimum(monkeypatch):
    from repro_torch.kernels.autotune import measure

    # calls in ABBA order a, b, b, a take 5, 2, 7 and 3 s
    ticks = iter([0.0, 5.0, 0.0, 2.0, 0.0, 7.0, 0.0, 3.0])
    monkeypatch.setattr(measure.time, "perf_counter", lambda: next(ticks))
    best = at.time_paired({"a": lambda: None, "b": lambda: None}, iters=2)
    assert best == {"a": 3e6, "b": 2e6}


def test_time_fn_median_after_warm_up_on_the_operands_device():
    calls = []
    x = torch.zeros(3, dtype=torch.int32)
    us = at.time_fn(lambda t, k=0: calls.append((t.device.type, k)), x, k=2, iters=5, warmup=3)
    assert calls == [("cpu", 2)] * 8 and 0 <= us < 1e6


# ---------------------------------------------------------------------------
# Keys and problem lists: JAX's letter for letter
# ---------------------------------------------------------------------------


def _keys(problems, backend, key_fn):
    return [key_fn(p["op"], p["shape"], p["dtype"], backend, p["conv_mode"], p["fuse_bwd"])
            for p in problems]


@pytest.mark.parametrize("name", ["tiny", "vgg8b", "vgg11b", "mlp4"])
def test_training_shapes_and_keys_are_jax(name):
    cfg, jcfg = _cfgs(name)
    for batch in (4, 64):
        for mode in ("stream", "materialise"):
            got = at.training_shapes(cfg, batch, conv_mode=mode)
            want = jat.training_shapes(jcfg, batch, conv_mode=mode)
            assert got == want
            for backend in ("reference", "cuda"):
                assert _keys(got, backend, at.cache_key) == _keys(want, backend, jat.cache_key)


@pytest.mark.parametrize("name", ["tiny", "vgg8b", "vgg11b", "mlp4"])
def test_plan_shapes_and_keys_are_jax(name, tmp_path):
    fm, jfm = _frozen(name, tmp_path)
    for od in ("auto", "int32"):
        plan = compile_plan(fm, device="cpu", operand_dtype=od)
        jplan = jcompile_plan(jfm, backend="reference", operand_dtype=od)
        for batch in (1, 32):
            got, want = at.plan_shapes(plan, batch), jat.plan_shapes(jplan, batch)
            assert got == want and len(got) == len(plan.metas)
            assert _keys(got, "reference", at.cache_key) == _keys(want, "reference",
                                                                  jat.cache_key)


def test_cache_key_dtypes_as_torch_or_strings():
    for xd, wd in ((torch.int32, torch.int32), (torch.int8, torch.int8),
                   (torch.int32, torch.int8)):
        name = f"{str(xd)[6:]},{str(wd)[6:]}"
        got = at.cache_key("conv", (2, 8, 8, 3, 3, 8), (xd, wd), "cuda", "stream", True, True)
        assert got == at.cache_key("conv", (2, 8, 8, 3, 3, 8), name, "cuda", "stream", 1, 1)
        assert got == jat.cache_key("conv", (2, 8, 8, 3, 3, 8), name, "cuda", "stream",
                                    True, True)
        assert "torch" not in got


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


def test_cache_round_trip_and_file_is_jaxs_shape(tmp_path):
    cache = at.TileCache(str(tmp_path), device="cpu")
    jcache = jat.TileCache(str(tmp_path / "jax"))
    key = at.cache_key("matmul", (64, 96, 128), "int32,int32", "reference")
    cache.put(key, at.TileConfig(bh=4))
    jcache.put(key, jat.TileConfig(bh=4))
    assert at.TileCache(str(tmp_path), device="cpu").get(key) == at.TileConfig(bh=4)
    assert cache.path == str(tmp_path / at.CACHE_FILENAME) == str(tmp_path / jat.CACHE_FILENAME)
    got, want = (json.loads(Path(p).read_text()) for p in (cache.path, jcache.path))
    assert got["entries"] == want["entries"]
    assert got["fingerprint"] == at.build_fingerprint("cpu")


def test_corrupt_file_is_an_empty_cache(tmp_path):
    path = tmp_path / "tile_cache.json"
    for text in ("{not json", "[]", '{"fingerprint": 1}', '{"entries": {"k": {"bm": 0}}}'):
        path.write_text(text)
        cache = at.TileCache(str(path), device="cpu")
        assert len(cache) == 0
    cache.put("k", at.DEFAULT_TILES)  # and it recovers by rewriting
    assert at.TileCache(str(path), device="cpu").get("k") == at.DEFAULT_TILES


def test_other_fingerprint_invalidates(tmp_path):
    path = str(tmp_path / "tile_cache.json")
    at.TileCache(path, fingerprint="repro_torch=0.0|torch=old|device=cpu").put(
        "k", at.TileConfig(bh=2))
    fresh = at.TileCache(path, device="cpu")
    assert len(fresh) == 0 and "k" not in fresh
    fp = at.build_fingerprint("cpu")
    assert fp.startswith("repro_torch=") and fp.endswith("|device=cpu")
    assert f"torch={torch.__version__}" in fp


def test_concurrent_thread_writers_lose_no_entry(tmp_path):
    path = str(tmp_path / "tile_cache.json")

    def write(i):
        at.TileCache(path, device="cpu").put(f"k{i}", at.TileConfig(bh=1 + i))

    threads = [threading.Thread(target=write, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    final = at.TileCache(path, device="cpu")
    assert {k: final.get(k).bh for k in final.keys()} == {f"k{i}": 1 + i for i in range(8)}
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tile_cache.")]


def test_concurrent_process_writers_lose_no_entry(tmp_path):
    path = str(tmp_path / "tile_cache.json")
    code = (
        "import sys\n"
        "from repro_torch.kernels.autotune import TileCache, TileConfig\n"
        "w = int(sys.argv[2])\n"
        "for i in range(6):\n"
        "    TileCache(sys.argv[1], device='cpu').put(f'p{w}-{i}', TileConfig(bm=1 + w, bh=1 + i))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", code, path, str(w)], env=env)
             for w in range(4)]
    assert all(p.wait(timeout=120) == 0 for p in procs)
    final = at.TileCache(path, device="cpu")
    assert len(final) == 24
    assert all(final.get(f"p{w}-{i}") == at.TileConfig(bm=1 + w, bh=1 + i)
               for w in range(4) for i in range(6))


# ---------------------------------------------------------------------------
# Resolution: counters, the memo, the int8 gauge
# ---------------------------------------------------------------------------


def test_resolve_tiles_none_without_cache_builds_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a key was built with no cache configured")

    monkeypatch.setattr(state, "cache_key", boom)
    assert at.resolve_tiles("matmul", (8, 8, 8), dtype="int32,int32",
                            backend="reference") is None
    x, w = torch.from_numpy(_ints((4, 8))), torch.from_numpy(_ints((8, 4)))
    mm_ops.fused_matmul(x, w, sf=16)
    conv_ops.fused_conv(torch.from_numpy(_ints((1, 6, 6, 3))),
                        torch.from_numpy(_ints((3, 3, 3, 4))), sf=27)
    assert state._memo == {}


def test_hit_and_miss_counters_are_jaxs(tmp_path):
    counts = {}
    for pkg, registry in ((at, MetricRegistry()), (jat, JMetricRegistry())):
        cache = pkg.TileCache(str(tmp_path / pkg.__name__))
        key = pkg.cache_key("matmul", (8, 16, 8), "int32,int32", "interpret")
        cache.put(key, pkg.TileConfig(bm=32))
        pkg.set_metrics(registry)
        pkg.configure(cache)
        hit = pkg.resolve_tiles("matmul", (8, 16, 8), dtype="int32,int32",
                                backend="interpret")
        miss = pkg.resolve_tiles("matmul", (9, 9, 9), dtype="int32,int32",
                                 backend="interpret")
        assert hit == pkg.TileConfig(bm=32) and miss is None
        snap = registry.json_snapshot()
        counts[pkg.__name__] = [snap[f"kernel_tile_cache_{k}_total"]["samples"][0]["value"]
                                for k in ("hits", "misses")]
    assert counts[at.__name__] == counts[jat.__name__] == [1, 1]


def test_a_key_is_counted_once_until_the_next_configure(tmp_path):
    cache = at.TileCache(str(tmp_path), device="cpu")
    key = at.cache_key("conv_grad_w", (2, 8, 8, 3, 3, 8), "int32,int32", "cuda", "stream", True)
    cache.put(key, at.TileConfig(bh=3))
    reg = MetricRegistry()
    at.set_metrics(reg)
    at.configure(cache)

    def resolve(dtype):
        return at.resolve_tiles("conv_grad_w", (2, 8, 8, 3, 3, 8), dtype=dtype,
                                backend="cuda", conv_mode="stream", fuse_bwd=True)

    def counts():
        snap = reg.json_snapshot()
        return [snap[f"kernel_tile_cache_{k}_total"]["samples"][0]["value"]
                for k in ("hits", "misses")]

    for _ in range(3):  # torch dtypes and the string reach the same key
        assert resolve((torch.int32, torch.int32)) == at.TileConfig(bh=3)
        assert resolve("int32,int32") == at.TileConfig(bh=3)
        assert at.resolve_tiles("matmul", (1, 2, 3), dtype="int8,int8",
                                backend="cuda") is None
    assert counts() == [1, 1]
    at.configure(cache)  # forgets: the next resolutions count again
    resolve("int32,int32")
    assert counts() == [2, 1]


def test_concurrent_resolutions_count_each_key_once(tmp_path):
    """Threads resolving the same keys at once (a short switch interval):
    each key is counted once and every thread gets the cached tiles."""
    cache = at.TileCache(str(tmp_path), device="cpu")
    shapes = [(b, 16, 8) for b in range(1, 9)]
    for sh in shapes[::2]:
        cache.put(at.cache_key("matmul_fwd", sh, "int32,int32", "reference"),
                  at.TileConfig(bh=sh[0]))
    reg = MetricRegistry()
    at.set_metrics(reg)
    at.configure(cache)
    errors = []

    def work():
        try:
            for _ in range(50):
                for sh in shapes:
                    got = at.resolve_tiles("matmul_fwd", sh, dtype=(torch.int32, torch.int32),
                                           backend="reference")
                    if got != (at.TileConfig(bh=sh[0]) if sh[0] % 2 else None):
                        errors.append((sh, got))
        except Exception as e:  # reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    snap = reg.json_snapshot()
    assert [snap[f"kernel_tile_cache_{k}_total"]["samples"][0]["value"]
            for k in ("hits", "misses")] == [4, 4]


def test_int8_gauge_matches_jax_on_frozen_vgg8b_at_digits28(tmp_path):
    fm, jfm = _frozen("vgg8b", tmp_path, input_shape=(28, 28, 1))
    reg, jreg = MetricRegistry(), JMetricRegistry()
    at.set_metrics(reg)
    jat.set_metrics(jreg)
    plan = compile_plan(fm, device="cpu")
    jplan = jcompile_plan(jfm, backend="reference")

    def gauge(r):
        return {s["labels"]["layer"]: s["value"]
                for s in r.json_snapshot()["kernel_int8_path_active"]["samples"]}

    assert gauge(reg) == gauge(jreg) == {
        f"{fm.name}/{i}": int(m.operand_dtype == "int8") for i, m in enumerate(plan.metas)}
    assert [m.operand_dtype for m in plan.metas] == [m.operand_dtype for m in jplan.metas]
    assert 0 < sum(gauge(reg).values()) < len(plan.metas)


def test_plan_logits_tile_invariant_via_cache(tmp_path):
    cfg, _ = _tiny_cfgs()
    params = M.init_params(prng.PRNGKey(0), cfg, device="cpu")
    fm = freeze(params, cfg)
    x = _ints((4, 8, 8, 3), -127, 128, seed=11)
    want = M.frozen_forward(params, cfg, torch.from_numpy(x))
    cache = at.TileCache(str(tmp_path), device="cpu")
    plan = compile_plan(fm, device="cpu")
    problems = at.plan_shapes(plan, 4)
    for p in problems:
        if p["op"] == "conv":  # a band height the automatic choice never takes
            cache.put(at.cache_key(p["op"], p["shape"], p["dtype"], "reference",
                                   p["conv_mode"], p["fuse_bwd"]), at.TileConfig(bh=3))
    reg = MetricRegistry()
    at.set_metrics(reg)
    at.configure(cache)
    seen = []
    orig = conv_ops.conv_ref.stream_conv_ref

    def spy(*a, **kw):
        seen.append(kw["bh"])
        return orig(*a, **kw)

    conv_ops.conv_ref.stream_conv_ref = spy
    try:
        got = [compile_plan(fm, device="cpu").logits(x) for _ in range(2)]
    finally:
        conv_ops.conv_ref.stream_conv_ref = orig
    for g in got:
        _eq(g, want.numpy())
    assert seen == [3, 3]
    snap = reg.json_snapshot()
    assert snap["kernel_tile_cache_hits_total"]["samples"][0]["value"] == 1
    assert snap["kernel_tile_cache_misses_total"]["samples"][0]["value"] == len(problems) - 1


@pytest.mark.parametrize("od", ["auto", "int32"])
@pytest.mark.parametrize("mode", ["stream", "materialise"])
def test_plan_looks_up_the_jax_plans_keys(od, mode, tmp_path):
    """A plan's dispatchers look up the keys the JAX plan's do: the frozen
    weight's dtype although int32-operand steps hold it lifted, and a
    materialise conv's miss falling through to its inner matmul."""
    fm, jfm = _frozen("tiny", tmp_path / "fm")
    x = _ints((2, 8, 8, 3), -127, 128, seed=5)
    asked = {}
    for pkg, kw in ((at, {"device": "cpu"}), (jat, {})):
        keys = asked.setdefault(pkg.__name__, set())

        class Recording(pkg.TileCache):
            def get(self, key):
                keys.add(key)
                return super().get(key)

        pkg.configure(Recording(str(tmp_path / pkg.__name__), **kw))
        if pkg is at:
            compile_plan(fm, device="cpu", conv_mode=mode, operand_dtype=od).logits(x)
        else:
            jcompile_plan(jfm, backend="reference", conv_mode=mode,
                          operand_dtype=od).logits(jnp.asarray(x))
        pkg.configure(None)
    assert asked[at.__name__] == asked[jat.__name__]
    assert any("|int32,int8|" in k or "|int8,int8|" in k for k in asked[at.__name__])


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def test_tune_reference_conv_is_gated_and_caches_the_winner(tmp_path):
    cache = at.TileCache(str(tmp_path), device="cpu")
    shape = (1, 8, 8, 3, 3, 8)
    winner, times = at.tune("conv", shape, backend="reference", cache=cache, iters=1,
                            device="cpu")
    default = at.TileConfig(bh=4)  # conv_geometry's automatic band at H = 8
    assert default in times and winner in times
    assert times[winner] == min(times.values()) <= times[default]
    assert {c.bh for c in times} == {c.bh for c in at.conv_candidates(8, 8, 3, 3, 8)} | {4}
    key = jat.cache_key("conv", shape, "int32,int32", "reference", "stream", False)
    assert cache.keys() == [key] and cache.get(key) == winner


@pytest.mark.parametrize("op,shape", [
    ("conv_fwd", (1, 8, 8, 3, 3, 8)), ("conv_grad_w", (1, 8, 8, 3, 3, 8)),
    ("conv_grad_x", (1, 8, 8, 8, 3, 3)),
])
def test_tune_training_convs_on_reference(op, shape):
    winner, times = at.tune(op, shape, backend="reference", iters=1, device="cpu")
    assert winner in times and len(times) >= 3
    assert all(c == at.TileConfig(bh=c.bh) for c in times)


def test_fuse_opt_lookup_misses_after_tuning_as_jaxs_does(tmp_path):
    """The JAX quirk kept on purpose: ``tune`` keys ``conv_grad_w`` without
    ``fuse_opt`` (JAX's ``tune`` stores ``cache_key(op, shape, dtype,
    backend, conv_mode, fuse_bwd)``), so #9's lookup (``fuse_opt=True``)
    misses in both packages while #8's hits."""
    shape = (1, 6, 6, 3, 3, 4)
    cache = at.TileCache(str(tmp_path / "port"), device="cpu")
    winner, _ = at.tune("conv_grad_w", shape, backend="reference", cache=cache, iters=1,
                        device="cpu")
    assert cache.keys() == [jat.cache_key("conv_grad_w", shape, "int32,int32", "reference",
                                          "stream", True)]
    jcache = jat.TileCache(str(tmp_path / "jax"))
    jcache.put(cache.keys()[0], jat.TileConfig.from_json(winner.to_json()))
    found = {}
    for pkg, c in ((at, cache), (jat, jcache)):
        pkg.configure(c)
        found[pkg.__name__] = [
            pkg.resolve_tiles("conv_grad_w", shape, dtype="int32,int32", backend="reference",
                              conv_mode="stream", fuse_bwd=True, fuse_opt=fo) is not None
            for fo in (False, True)]
        pkg.configure(None)
    assert found[at.__name__] == found[jat.__name__] == [True, False]


def test_parity_gate_refuses_a_result_changing_candidate(monkeypatch):
    orig = search._build

    def build(op, operands, *, tiles, **kw):
        fn = orig(op, operands, tiles=tiles, **kw)
        if tiles is not None and tiles.bh == 2:
            return lambda: fn() + 1
        return fn

    monkeypatch.setattr(search, "_build", build)
    with pytest.raises(at.ParityError, match="bitwise"):
        at.tune("conv", (1, 8, 8, 3, 3, 8), backend="reference", iters=1, device="cpu")


UNTUNABLE_CPU = [("matmul", (8, 8, 8), "stream"), ("matmul_fwd", (8, 8, 8), "stream"),
                 ("matmul_grad_w", (8, 8, 8), "stream"), ("matmul_grad_x", (8, 8, 8), "stream"),
                 ("conv", (1, 8, 8, 3, 3, 8), "materialise"),
                 ("conv_fwd", (1, 8, 8, 3, 3, 8), "materialise"),
                 ("conv_grad_w", (1, 8, 8, 3, 3, 8), "materialise"),
                 ("conv_grad_x", (1, 8, 8, 8, 3, 3), "materialise")]


@pytest.mark.parametrize("op,shape,mode", UNTUNABLE_CPU)
def test_untunable_reference_combinations_return_none(op, shape, mode):
    assert at.tune(op, shape, backend="reference", conv_mode=mode, device="cpu") == (None, {})
    # JAX's reference backend has the same knobless set
    assert jat.tune(op, shape, backend="reference", conv_mode=mode) == (None, {})


@pytest.mark.parametrize("op", search.MATMUL_OPS + search.CONV_OPS)
@pytest.mark.parametrize("mode", ["stream", "materialise"])
def test_nothing_is_tunable_on_cuda(op, mode):
    """The CUDA kernels' tiles are compiled in and their split-K counts
    planned at launch: every op on ``cuda`` has no knob, as JAX's reference
    matmuls have none."""
    assert search._untunable(op, "cuda", mode if op in search.CONV_OPS else "")


def test_tune_rejects_unknown_ops_and_cuda_on_cpu():
    with pytest.raises(ValueError, match="unknown op"):
        at.tune("gemm", (8, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="needs CUDA"):
        at.tune("matmul", (8, 8, 8), backend="cuda", device="cpu")


def test_tune_plan_second_call_measurement_free(tmp_path, monkeypatch):
    cfg, _ = _tiny_cfgs()
    plan = compile_plan(freeze(M.init_params(prng.PRNGKey(0), cfg, device="cpu"), cfg),
                        device="cpu")
    cache = at.TileCache(str(tmp_path), device="cpu")
    first = at.tune_plan(plan, 4, cache=cache, iters=1)
    assert len(first) == 1  # the conv step; the matmuls have no knob on reference
    outcomes = []
    orig = search.tune

    def spy(*a, **kw):
        out = orig(*a, **kw)
        outcomes.append(out)
        return out

    monkeypatch.setattr(search, "tune", spy)
    assert at.tune_plan(plan, 4, cache=cache, iters=1) == first
    assert outcomes and all(out == (None, {}) for out in outcomes)


def test_tune_training_keys_are_jaxs_tunable_set(tmp_path):
    cfg, jcfg = _tiny_cfgs()
    cache = at.TileCache(str(tmp_path), device="cpu")
    tuned = at.tune_training(cfg, 2, cache=cache, iters=1, device="cpu")
    want = [k for k in _keys(jat.training_shapes(jcfg, 2), "reference", jat.cache_key)
            if k.startswith("conv")]
    assert sorted(tuned) == sorted(want) == cache.keys()


# ---------------------------------------------------------------------------
# Every dispatcher takes tiles=; results never move
# ---------------------------------------------------------------------------

DISPATCHERS = [mm_ops.fused_matmul, mm_ops.fused_matmul_fwd, mm_ops.grad_w_matmul,
               mm_ops.grad_w_opt_matmul, mm_ops.grad_x_matmul, conv_ops.fused_conv,
               conv_ops.fused_conv_fwd, conv_ops.conv_grad_w, conv_ops.conv_grad_w_opt,
               conv_ops.conv_grad_x, grad_ops.linear_grads, grad_ops.conv_grads,
               grad_ops.linear_weight_update, grad_ops.conv_weight_update]


@pytest.mark.parametrize("fn", DISPATCHERS, ids=lambda f: f.__name__)
def test_every_dispatcher_takes_tiles(fn):
    p = inspect.signature(fn).parameters["tiles"]
    assert p.default is None and p.kind == p.KEYWORD_ONLY


def test_matmul_dispatchers_ignore_tiles_on_reference():
    x, w = torch.from_numpy(_ints((16, 48), seed=8)), torch.from_numpy(_ints((48, 32), seed=9))
    delta = torch.from_numpy(_ints((16, 32), seed=10))
    sf = linear_scale_factor(48)
    _, z = mm_ops.fused_matmul_fwd(x, w, sf=sf)
    for t in (None, at.TileConfig(bm=8), at.TileConfig(bm=8, bh=3)):
        assert torch.equal(mm_ops.fused_matmul(x, w, sf=sf, tiles=t),
                           mm_ops.fused_matmul(x, w, sf=sf))
        for g, r in zip(grad_ops.linear_grads(x, w, delta, z_star=z, tiles=t),
                        grad_ops.linear_grads(x, w, delta, z_star=z), strict=True):
            assert torch.equal(g, r)


@given(bh=st.sampled_from([1, 2, 3, 5, 8, 32]), pool=st.booleans(),
       mode=st.sampled_from(["stream", "materialise"]))
@settings(max_examples=6, deadline=None)
def test_reference_conv_and_conv_grads_any_band_equal_jax(bh, pool, mode):
    x, w = _ints((2, 12, 12, 3), seed=3), _ints((3, 3, 3, 16), seed=4)
    delta = _ints((2, 12, 12, 16), -2 ** 20, 2 ** 20, seed=7)
    sf = conv_scale_factor(3, 3)
    tile = at.TileConfig(bh=bh)
    tx, tw, td = (torch.from_numpy(v) for v in (x, w, delta))
    got = conv_ops.fused_conv(tx, tw, sf=sf, pool=pool, conv_mode=mode, tiles=tile)
    _eq(got, jfused_conv(jnp.asarray(x), jnp.asarray(w), sf=sf, pool=pool,
                         backend="reference", conv_mode=mode))
    _, z = conv_ops.fused_conv_fwd(tx, tw, sf=sf, tiles=tile)
    _, jz = jfused_conv_fwd(jnp.asarray(x), jnp.asarray(w), sf=sf, backend="reference")
    _eq(z, jz)
    got = conv_ops.conv_grad_w(tx, td, kernel_size=3, z_star=z, tiles=tile, conv_mode=mode)
    gx, gw = grad_ops.conv_grads(tx, tw, td, z_star=z, conv_mode=mode, tiles=tile)
    jgx, jgw = jconv_grads(jnp.asarray(x), jnp.asarray(w), jnp.asarray(delta), z_star=jz,
                           backend="reference", conv_mode=mode)
    _eq(got, jgw)
    _eq(gw, jgw)
    _eq(gx, jgx)
