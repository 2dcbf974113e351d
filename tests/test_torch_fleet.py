"""PyTorch port, the serving control plane held against the JAX package.

The counterpart of ``tests/test_fleet.py`` on the same handcrafted tiny
FrozenModels, rebuilt in torch (the plain PyTorch path on the CPU):

  * bit-exactness — fleet-routed logits ≡ standalone VisionEngine ≡ the
    raw ExecutionPlan, and ≡ the JAX package's FleetEngine on the same
    weights, arms and request ids;
  * registry — hot-swap atomicity under concurrent submission, shared pad
    buffers, eviction, SLOs through the lifecycle;
  * scheduler — per-model FIFO, backpressure, weighted round-robin,
    idle coalescing, anti-starvation, drain-on-close, cancellation;
  * router — the port's arm ≡ JAX's for the same request id;
  * manifest — FLEET.json round-trip + frozen checkpoint versioning;
  * stats — ``slo_summary`` / ``fleet_snapshot_delta`` ≡ JAX's.

Queue states are arranged with ``GatedPlan``'s gate and its ``entered``
event, and every ``Future.result`` has a timeout, so a hang fails.
"""

import json
import os
import tempfile
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import model as JM
from repro.infer import freeze as j_freeze
from repro.serving import FleetEngine as JFleetEngine
from repro.serving import ModelRegistry as JModelRegistry
from repro.serving import Router as JRouter
from repro.serving import stats as jstats
from repro_torch.configs import paper as tpaper
from repro_torch.core import model as TM
from repro_torch.core.scaling import linear_scale_factor
from repro_torch.infer import (
    compile_plan,
    freeze,
    load_fleet_manifest,
    load_frozen,
    prune_frozen,
    save_fleet_manifest,
    save_frozen,
)
from repro_torch.infer.export import FrozenLayer, FrozenModel
from repro_torch.serving import (
    EngineStats,
    FleetEngine,
    ModelRegistry,
    Router,
    Slo,
    VisionEngine,
    fleet_snapshot_delta,
    latency_summary_ms,
    parse_split,
    percentile,
    slo_summary,
)
from repro_torch.serving import stats as tstats

IN_DIM, HIDDEN, CLASSES = 8, 16, 10
T = 30  # seconds: every wait in this file is bounded


def tiny_model(seed: int, in_dim: int = IN_DIM, name: str | None = None):
    """Two-layer integer MLP FrozenModel (``tests/test_fleet.py``'s weights)."""
    rng = np.random.default_rng(seed)
    w1 = torch.from_numpy(rng.integers(-20, 21, (in_dim, HIDDEN)).astype(np.int8))
    w2 = torch.from_numpy(rng.integers(-20, 21, (HIDDEN, CLASSES)).astype(np.int8))
    return FrozenModel(
        layers=(
            FrozenLayer("linear", w1, linear_scale_factor(in_dim),
                        alpha_inv=2, apply_relu=True, pool=False),
            FrozenLayer("output", w2, linear_scale_factor(HIDDEN),
                        alpha_inv=0, apply_relu=False, pool=False),
        ),
        input_shape=(in_dim,),
        num_classes=CLASSES,
        name=name or f"tiny-{seed}",
    )


def images(n: int, seed: int = 7, in_dim: int = IN_DIM):
    rng = np.random.default_rng(seed)
    return [rng.integers(-127, 128, (in_dim,)).astype(np.int32)
            for _ in range(n)]


def reference_registry(**models) -> ModelRegistry:
    reg = ModelRegistry(device="cpu", backend="reference")
    for mid, fm in models.items():
        reg.register(mid, fm)
    return reg


def plan_logits(fm, imgs) -> np.ndarray:
    return compile_plan(fm, device="cpu", backend="reference").logits(
        np.stack(imgs)).numpy()


class GatedPlan:
    """Plan wrapper whose logits block until released — makes queue state
    deterministic in the scheduler tests (the worker parks inside the
    launch, ``entered`` set, while the test arranges queues)."""

    def __init__(self, plan):
        self._plan = plan
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.calls = []  # batches seen, in launch order
        self.input_shape = plan.input_shape
        self.num_classes = plan.num_classes
        self.name = plan.name
        self.backend = plan.backend
        self.device = plan.device

    def logits(self, x):
        self.entered.set()
        assert self.gate.wait(T), "gate never opened"
        self.calls.append(np.asarray(x))
        return self._plan.logits(x)


def gate(reg, mid) -> GatedPlan:
    gated = GatedPlan(reg.get(mid).plan)
    reg.get(mid).plan = gated
    return gated


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------


class TestStats:
    def test_percentile_nearest_rank(self):
        vals = [1.0, 2.0, 3.0, 4.0]
        assert percentile([], 0.5) == 0.0
        assert percentile(vals, 0.0) == 1.0
        assert percentile(vals, 0.5) == 2.0
        assert percentile(vals, 0.99) == 4.0
        assert percentile(vals, 1.0) == 4.0

    def test_latency_summary_keys_and_units(self):
        out = latency_summary_ms([0.001, 0.002, 0.003])
        assert set(out) == {"p50", "p90", "p95", "p99"}
        assert out["p99"] == pytest.approx(3.0)

    def test_snapshot_consistent_under_concurrent_writes(self):
        stats = EngineStats()
        n_threads, n_batches = 4, 200

        def writer():
            for _ in range(n_batches):
                stats.record_batch(3, 1, 0.01)

        threads = [threading.Thread(target=writer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            snap = stats.snapshot()
            assert snap["requests"] == 3 * snap["batches"]
            assert snap["padded_slots"] == snap["batches"]
        for t in threads:
            t.join(T)
            assert not t.is_alive()
        snap = stats.snapshot()
        assert snap["batches"] == n_threads * n_batches
        assert snap["avg_batch_fill"] == pytest.approx(0.75)
        assert "p99" in snap["batch_latency_ms"]
        # the JAX EngineStats' read properties
        assert stats.requests == 3 * 800 and stats.batches == 800
        assert stats.padded_slots == 800
        assert stats.avg_batch_fill == pytest.approx(0.75)
        assert len(stats.batch_latency_s) == 800

    def test_constants_match_jax(self):
        for name in ("REQUESTS_TOTAL", "BATCHES_TOTAL", "PADDED_SLOTS_TOTAL",
                     "BATCH_LATENCY_SECONDS", "REQUEST_DEADLINE_SECONDS",
                     "SLO_VIOLATIONS_TOTAL", "SLO_DEADLINE_SECONDS",
                     "SLACK_BUCKETS", "PERCENTILES"):
            assert getattr(tstats, name) == getattr(jstats, name), name

    @pytest.mark.parametrize("slo_ms", [None, 0.001, 20.0, 50.0, 1e4])
    def test_slo_summary_matches_jax(self, slo_ms):
        rng = np.random.default_rng(3)
        lats = list(rng.exponential(0.02, 257)) + [0.05, 0.05]
        tslo = None if slo_ms is None else Slo(deadline_ms=slo_ms)
        jslo = None if slo_ms is None else jstats.Slo(deadline_ms=slo_ms)
        assert slo_summary(lats, tslo) == jstats.slo_summary(lats, jslo)
        assert slo_summary([], tslo) == jstats.slo_summary([], jslo)

    def test_fleet_snapshot_delta_matches_jax(self):
        def snap(reqs):
            return {"fleet": {"requests": sum(r for r, _, _ in reqs.values()),
                              "batches": sum(b for _, b, _ in reqs.values()),
                              "padded_slots": sum(p for _, _, p in reqs.values())},
                    "models": {m: {"requests": r, "batches": b, "padded_slots": p,
                                   "version": 0}
                               for m, (r, b, p) in reqs.items()}}

        pre = snap({"a": (10, 2, 6), "b": (3, 1, 5)})
        post = snap({"a": (74, 4, 6), "b": (3, 1, 5), "c": (5, 1, 3)})
        got = fleet_snapshot_delta(pre, post)
        assert got == jstats.fleet_snapshot_delta(pre, post)
        assert got["models"]["c"]["requests"] == 5  # registered after pre
        assert got["models"]["b"]["avg_batch_fill"] == 0.0


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class TestModelRegistry:
    def test_register_get_evict(self):
        reg = reference_registry(a=tiny_model(0), b=tiny_model(1))
        assert reg.ids() == ["a", "b"]
        assert "a" in reg and len(reg) == 2
        assert reg.get("a").plan.name == "tiny-0"
        with pytest.raises(ValueError, match="already registered"):
            reg.register("a", tiny_model(2))
        with pytest.raises(ValueError, match="non-empty"):
            reg.register("", tiny_model(2))
        reg.evict("a")
        assert "a" not in reg
        with pytest.raises(KeyError, match="unknown model id"):
            reg.get("a")
        with pytest.raises(KeyError):
            reg.evict("a")

    def test_shared_pad_buffer_per_input_shape(self):
        reg = reference_registry(a=tiny_model(0), b=tiny_model(1))
        reg.register("c", tiny_model(2, in_dim=4))
        pad_ab = reg.pad_buffer(reg.get("a").input_shape)
        assert pad_ab is reg.pad_buffer(reg.get("b").input_shape)
        assert pad_ab is not reg.pad_buffer(reg.get("c").input_shape)
        assert not pad_ab.flags.writeable  # shared: must stay zero
        assert pad_ab.shape == (IN_DIM,) and pad_ab.dtype == np.int32

    def test_swap_bumps_version_keeps_stats_rejects_shape_change(self):
        reg = reference_registry(a=tiny_model(0))
        entry = reg.get("a")
        entry.stats.record_batch(4, 0, 0.01)
        old_plan = entry.plan
        swapped = reg.swap("a", tiny_model(5))
        assert swapped is entry  # stable identity
        assert entry.version == 1 and entry.plan is not old_plan
        assert entry.stats.snapshot()["requests"] == 4  # stats survive
        with pytest.raises(ValueError, match="input shape"):
            reg.swap("a", tiny_model(6, in_dim=4))
        with pytest.raises(KeyError):
            reg.swap("nope", tiny_model(7))

    def test_snapshot_shape(self):
        reg = reference_registry(a=tiny_model(0))
        snap = reg.snapshot()
        assert snap["a"]["version"] == 0
        assert snap["a"]["model"] == "tiny-0"
        assert snap["a"]["requests"] == 0
        assert snap["a"]["slo_ms"] is None

    def test_registry_compiles_on_its_device_and_backend(self):
        reg = ModelRegistry(device="cpu", operand_dtype="int32")
        entry = reg.register("a", tiny_model(0))
        assert entry.plan.device == torch.device("cpu")
        assert entry.plan.backend == "reference"  # 'auto' on the CPU
        assert [m.operand_dtype for m in entry.plan.metas] == ["int32", "int32"]
        assert reg.register("b", tiny_model(1), operand_dtype="auto").plan.metas[1] \
            .operand_dtype == "int8"


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


class TestRouter:
    def test_concrete_id_passthrough(self):
        assert Router().resolve("prod", "r1") == "prod"

    def test_deterministic_assignment(self):
        router = Router({"split": {"a": 0.5, "b": 0.5}})
        arms = [router.resolve("split", f"req-{i}") for i in range(64)]
        again = [router.resolve("split", f"req-{i}") for i in range(64)]
        assert arms == again
        assert set(arms) == {"a", "b"}

    def test_split_fractions_converge(self):
        router = Router({"split": {"a": 0.9, "b": 0.1}})
        n = 4000
        hits = sum(router.resolve("split", f"id-{i}") == "b"
                   for i in range(n))
        assert 0.07 < hits / n < 0.13

    def test_weights_normalised(self):
        r1 = Router({"s": {"a": 9.0, "b": 1.0}})
        r2 = Router({"s": {"a": 0.9, "b": 0.1}})
        ids = [f"x{i}" for i in range(256)]
        assert [r1.resolve("s", i) for i in ids] == \
            [r2.resolve("s", i) for i in ids]

    def test_parse_split(self):
        assert parse_split("a=0.9,b=0.1") == {"a": 0.9, "b": 0.1}
        with pytest.raises(ValueError):
            parse_split("a0.9")
        with pytest.raises(ValueError):
            parse_split("=0.5")

    def test_invalid_splits_rejected(self):
        with pytest.raises(ValueError, match="no arms"):
            Router({"s": {}})
        with pytest.raises(ValueError, match="sum > 0"):
            Router({"s": {"a": 0.0}})
        with pytest.raises(ValueError, match="negative"):
            Router({"s": {"a": 2.0, "b": -1.0}})

    @pytest.mark.parametrize("splits", [
        {"split": {"a": 0.9, "b": 0.1}},
        {"s": {"b": 1.0, "a": 1.0, "c": 1.0}},
        {"x": {"prod": 3.0, "cand": 0.25}, "y": {"a": 1e-9, "b": 7.0}},
        {"one": {"only": 2.5}},
    ])
    def test_resolve_matches_jax_for_10000_ids(self, splits):
        """Weights that do not sum to 1 normalise the same way: the same
        request id lands on the same arm in both packages."""
        ours, theirs = Router(splits), JRouter(splits)
        assert ours.aliases == theirs.aliases
        for alias in splits:
            assert ours.arms(alias) == theirs.arms(alias)
            ids = [f"req-{i}" for i in range(10_000)]
            assert [ours.resolve(alias, r) for r in ids] == \
                [theirs.resolve(alias, r) for r in ids]
        assert ours.resolve("model-id", "r") == theirs.resolve("model-id", "r")


# ---------------------------------------------------------------------------
# fleet engine — numerics
# ---------------------------------------------------------------------------


class TestFleetNumerics:
    def test_fleet_bit_exact_with_vision_engine_and_plan(self):
        """Acceptance: routing is traffic control, never numerics."""
        fm = tiny_model(0)
        reg = reference_registry(m=fm)
        plan = compile_plan(fm, device="cpu", backend="reference")
        imgs = images(37)
        with FleetEngine(reg, batch_size=8) as eng:
            fleet = np.stack([eng.submit(i, model="m").result(T).logits
                              for i in imgs])
        with VisionEngine(plan, batch_size=8) as ve:
            vision = np.stack([f.result(T).logits
                               for f in [ve.submit(i) for i in imgs]])
        direct = plan.logits(np.stack(imgs)).numpy()
        np.testing.assert_array_equal(fleet, vision)
        np.testing.assert_array_equal(fleet, direct)
        assert fleet.dtype == np.int32

    def test_no_cross_model_answer_leakage(self):
        fm_a, fm_b = tiny_model(0), tiny_model(1)
        reg = reference_registry(a=fm_a, b=fm_b)
        imgs = images(48)
        want = {"a": plan_logits(fm_a, imgs), "b": plan_logits(fm_b, imgs)}
        with FleetEngine(reg, batch_size=4) as eng:
            futs = [(i, mid, eng.submit(imgs[i], model=mid))
                    for i in range(len(imgs)) for mid in ("a", "b")]
            for i, mid, fut in futs:
                np.testing.assert_array_equal(fut.result(T).logits, want[mid][i])

    def test_split_routes_and_labels(self):
        fm_a, fm_b = tiny_model(0), tiny_model(1)
        reg = reference_registry(a=fm_a, b=fm_b)
        router = Router({"split": {"a": 0.5, "b": 0.5}})
        imgs = images(32)
        want = {"a": plan_logits(fm_a, imgs), "b": plan_logits(fm_b, imgs)}
        with FleetEngine(reg, batch_size=8, router=router) as eng:
            for i, img in enumerate(imgs):
                rid = f"req-{i}"
                arm = router.resolve("split", rid)
                got = eng.submit(img, model="split", request_id=rid).result(T)
                np.testing.assert_array_equal(got.logits, want[arm][i])
                assert got.label == int(np.argmax(want[arm][i]))
        snap = reg.snapshot()
        assert snap["a"]["requests"] > 0 and snap["b"]["requests"] > 0
        assert snap["a"]["requests"] + snap["b"]["requests"] == len(imgs)

    def test_fleet_matches_jax_fleet_vision_engine_and_plan(self):
        """One frozen VGG8B (1/16 width) per arm carried across by
        ``params_from_numpy``: the port's FleetEngine ≡ the JAX package's
        FleetEngine ≡ the port's VisionEngine ≡ ``plan.logits``, arm by
        arm and request by request, dtype included."""
        jcfg = jpaper.get("vgg8b", scale=0.0625)
        cfg = tpaper.get("vgg8b", scale=0.0625)
        fms, jfms, jreg = {}, {}, JModelRegistry(backend="reference")
        for arm, seed in (("a", 0), ("b", 1)):
            jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
            np_tree = jax.tree_util.tree_map(np.asarray, jparams)
            fms[arm] = freeze(TM.params_from_numpy(np_tree, device="cpu"), cfg)
            jfms[arm] = j_freeze(jparams, jcfg)
            jreg.register(arm, jfms[arm])
        reg = reference_registry(**fms)
        splits = {"split": {"a": 0.7, "b": 0.3}}
        rng = np.random.default_rng(5)
        imgs = [rng.integers(-127, 128, cfg.input_shape).astype(np.int32)
                for _ in range(20)]
        rids = [f"req-{i}" for i in range(len(imgs))]
        with FleetEngine(reg, batch_size=4, router=Router(splits)) as eng:
            got = [f.result(T) for f in [
                eng.submit(im, model="split", request_id=r)
                for r, im in zip(rids, imgs)]]
            snap = eng.snapshot()
        with JFleetEngine(jreg, batch_size=4, router=JRouter(splits)) as jeng:
            jgot = [f.result(T) for f in [
                jeng.submit(im, model="split", request_id=r)
                for r, im in zip(rids, imgs)]]
            jsnap = jeng.snapshot()
        arms = [Router(splits).resolve("split", r) for r in rids]
        assert set(arms) == {"a", "b"}
        for arm in ("a", "b"):
            idx = [i for i, a in enumerate(arms) if a == arm]
            batch = np.stack([imgs[i] for i in idx])
            direct = compile_plan(fms[arm], device="cpu").logits(batch).numpy()
            with VisionEngine(compile_plan(fms[arm], device="cpu"),
                              batch_size=4) as ve:
                vision = [f.result(T) for f in [ve.submit(imgs[i]) for i in idx]]
            for k, i in enumerate(idx):
                assert got[i].logits.dtype == jgot[i].logits.dtype == np.int32
                np.testing.assert_array_equal(got[i].logits, jgot[i].logits)
                np.testing.assert_array_equal(got[i].logits, vision[k].logits)
                np.testing.assert_array_equal(got[i].logits, direct[k])
                assert got[i].label == jgot[i].label == vision[k].label
            assert snap["models"][arm]["requests"] == \
                jsnap["models"][arm]["requests"] == len(idx)


# ---------------------------------------------------------------------------
# fleet engine — scheduler behaviour
# ---------------------------------------------------------------------------


class TestFleetScheduler:
    def test_per_model_fifo_ordering(self):
        reg = reference_registry(a=tiny_model(0), b=tiny_model(1))
        order = {"a": [], "b": []}
        with FleetEngine(reg, batch_size=4) as eng:
            futs = []
            for i in range(40):
                mid = "a" if i % 2 == 0 else "b"
                fut = eng.submit(images(1, seed=i)[0], model=mid)
                fut.add_done_callback(
                    lambda f, mid=mid, i=i: order[mid].append(i))
                futs.append(fut)
            for f in futs:
                f.result(T)
        assert order["a"] == sorted(order["a"]) and len(order["a"]) == 20
        assert order["b"] == sorted(order["b"]) and len(order["b"]) == 20

    def test_backpressure_blocks_submit_until_drain(self):
        reg = reference_registry(m=tiny_model(0))
        gated = gate(reg, "m")
        depth = 2
        with FleetEngine(reg, batch_size=1, queue_depth=depth) as eng:
            imgs = images(depth + 3)
            first = eng.submit(imgs[0], model="m")
            assert gated.entered.wait(T)  # the first is in flight
            futs = [first] + [eng.submit(i, model="m")
                              for i in imgs[1:depth + 1]]
            blocked_fut = []
            blocker = threading.Thread(
                target=lambda: blocked_fut.append(
                    eng.submit(imgs[depth + 1], model="m")))
            blocker.start()
            blocker.join(timeout=0.3)
            assert blocker.is_alive(), "submit should block on a full queue"
            gated.gate.set()  # release the device; queue drains
            blocker.join(timeout=T)
            assert not blocker.is_alive()
            for f in futs + blocked_fut:
                assert f.result(T).logits.shape == (CLASSES,)

    def test_weighted_round_robin_shares_the_worker(self):
        reg = reference_registry(a=tiny_model(0), b=tiny_model(1))
        gated = gate(reg, "a")
        resolved = []
        with FleetEngine(reg, batch_size=1,
                         weights={"a": 3.0, "b": 1.0}) as eng:
            img = images(1)[0]
            futs = []

            def track(mid):
                fut = eng.submit(img, model=mid)
                fut.add_done_callback(lambda f, mid=mid: resolved.append(mid))
                futs.append(fut)

            track("a")  # parked in flight behind the gate
            assert gated.entered.wait(T)
            for _ in range(8):
                track("a")
            for _ in range(8):
                track("b")
            gated.gate.set()
            for f in futs:
                f.result(T)
        # smooth WRR at 3:1 — the first post-release picks go a,a,b,a
        assert resolved[1:5].count("b") == 1, resolved
        assert resolved.count("a") == 9 and resolved.count("b") == 8

    def test_idle_coalescing_merges_co_arriving_requests(self):
        reg = reference_registry(m=tiny_model(0))
        with FleetEngine(reg, batch_size=8, coalesce_ms=200.0) as eng:
            eng.classify(images(1), model="m")  # first call outside the window
            imgs = images(4)
            futs = []
            barrier = threading.Barrier(len(imgs))

            def submitter(img):
                barrier.wait(T)
                futs.append(eng.submit(img, model="m"))

            threads = [threading.Thread(target=submitter, args=(i,))
                       for i in imgs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(T)
                assert not t.is_alive()
            for f in list(futs):
                f.result(T)
            snap = eng.stats.snapshot()
        assert snap["batches"] == 2  # warmup + ONE coalesced batch
        assert snap["requests"] == 5

    def test_sustained_full_batches_do_not_starve_a_sparse_model(self):
        """While one model sustains full batches, a partial queue on
        another is served within about two flights (the same window as
        ``tests/test_fleet.py``)."""
        reg = reference_registry(hot=tiny_model(0), cold=tiny_model(1))

        class SlowPlan(GatedPlan):
            def logits(self, x):
                time.sleep(0.02)  # stretch each hot flight
                return self._plan.logits(x)

        reg.get("hot").plan = SlowPlan(reg.get("hot").plan)
        n_hot = 40
        with FleetEngine(reg, batch_size=2, queue_depth=n_hot) as eng:
            eng.classify(images(1, seed=9), model="hot")
            eng.classify(images(1, seed=9), model="cold")
            hot_futs = [eng.submit(i, model="hot")
                        for i in images(n_hot, seed=3)]
            time.sleep(0.05)  # let the hot pipeline get into flight
            t0 = time.perf_counter()
            cold = eng.submit(images(1, seed=4)[0], model="cold")
            cold.result(timeout=T)
            cold_latency = time.perf_counter() - t0
            for f in hot_futs:
                f.result(timeout=T)
        assert cold_latency < 0.2, f"cold starved for {cold_latency:.3f}s"

    def test_close_drains_queued_work(self):
        reg = reference_registry(m=tiny_model(0))
        gated = gate(reg, "m")
        eng = FleetEngine(reg, batch_size=4)
        futs = [eng.submit(i, model="m") for i in images(10)]
        gated.gate.set()
        eng.close()  # must resolve everything queued before returning
        assert all(f.done() for f in futs)
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(images(1)[0], model="m")
        eng.close()  # idempotent

    def test_submit_validation(self):
        reg = reference_registry(m=tiny_model(0))
        with FleetEngine(reg, batch_size=4) as eng:
            with pytest.raises(KeyError, match="unknown model id"):
                eng.submit(images(1)[0], model="ghost")
            with pytest.raises(ValueError, match="input shape"):
                eng.submit(np.zeros((3,), np.int32), model="m")

    def test_evicted_model_fails_queued_futures(self):
        reg = reference_registry(busy=tiny_model(0), victim=tiny_model(1))
        gated = gate(reg, "busy")
        with FleetEngine(reg, batch_size=1) as eng:
            hold = eng.submit(images(1)[0], model="busy")  # parks the worker
            assert gated.entered.wait(T)
            doomed = [eng.submit(i, model="victim") for i in images(3)]
            reg.evict("victim")
            gated.gate.set()
            hold.result(T)
            for f in doomed:
                with pytest.raises(RuntimeError, match="evicted"):
                    f.result(timeout=T)
            # scheduler state of the evicted model is dropped once its
            # queue drains and the worker next goes idle
            eng.submit(images(1)[0], model="busy").result(timeout=T)
            deadline = time.perf_counter() + 5
            while ("victim" in eng._queues
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
                eng.submit(images(1)[0], model="busy").result(timeout=T)
            assert "victim" not in eng._queues

    def test_cancelled_future_does_not_kill_the_worker(self):
        reg = reference_registry(m=tiny_model(0))
        gated = gate(reg, "m")
        with FleetEngine(reg, batch_size=2) as eng:
            hold = eng.submit(images(1)[0], model="m")  # parks the worker
            assert gated.entered.wait(T)
            queued = [eng.submit(i, model="m") for i in images(4, seed=1)]
            assert queued[1].cancel() and queued[2].cancel()
            gated.gate.set()
            hold.result(timeout=T)
            for f in (queued[0], queued[3]):  # engine still serves
                assert f.result(timeout=T).logits.shape == (CLASSES,)
            assert queued[1].cancelled() and queued[2].cancelled()
            late = eng.submit(images(1, seed=2)[0], model="m")
            assert late.result(timeout=T).logits.shape == (CLASSES,)

    def test_plan_failure_surfaces_on_futures_and_engine_survives(self):
        reg = reference_registry(m=tiny_model(0))

        class BoomPlan(GatedPlan):
            def logits(self, x):
                raise RuntimeError("boom")

        good_plan = reg.get("m").plan
        reg.get("m").plan = BoomPlan(good_plan)
        with FleetEngine(reg, batch_size=2) as eng:
            bad = eng.submit(images(1)[0], model="m")
            with pytest.raises(RuntimeError, match="boom"):
                bad.result(timeout=T)
            reg.get("m").plan = good_plan  # "hot-swap" back to a good plan
            ok = eng.submit(images(1)[0], model="m")
            assert ok.result(timeout=T).logits.shape == (CLASSES,)

    def test_fetch_failure_surfaces_on_futures(self):
        """A failure that surfaces only at the fetch (a fault on the card
        shows there) fails that batch's futures; the worker lives on."""
        reg = reference_registry(m=tiny_model(0))

        class Broken:
            def cpu(self):
                raise RuntimeError("device fault")

        class LatePlan(GatedPlan):
            def logits(self, x):
                return Broken()

        good_plan = reg.get("m").plan
        reg.get("m").plan = LatePlan(good_plan)
        with FleetEngine(reg, batch_size=2) as eng:
            with pytest.raises(RuntimeError, match="device fault"):
                eng.submit(images(1)[0], model="m").result(timeout=T)
            reg.get("m").plan = good_plan
            assert eng.submit(images(1)[0], model="m").result(T).logits.shape \
                == (CLASSES,)


# ---------------------------------------------------------------------------
# hot-swap under fire
# ---------------------------------------------------------------------------


class TestHotSwapConcurrency:
    def test_swap_under_concurrent_submit_resolves_everything(self):
        """Clients hammer one model id while checkpoints hot-swap beneath
        them: every future resolves, and every answer equals the old or
        the new checkpoint's logits for that image — never a mixture."""
        fm_v0, fm_v1 = tiny_model(0), tiny_model(1)
        reg = reference_registry(prod=fm_v0)
        imgs = images(24)
        want = {0: plan_logits(fm_v0, imgs), 1: plan_logits(fm_v1, imgs)}
        n_clients, per_client = 3, 40
        results = [[] for _ in range(n_clients)]
        stop_swapping = threading.Event()

        def swapper():
            version = 0
            while not stop_swapping.is_set():
                version ^= 1
                reg.swap("prod", (fm_v0, fm_v1)[version])
                time.sleep(0.002)

        def client(w):
            for k in range(per_client):
                i = (w * per_client + k) % len(imgs)
                logits = engine.submit(
                    imgs[i], model="prod").result(timeout=T).logits
                results[w].append((i, logits))

        with FleetEngine(reg, batch_size=4) as engine:
            sw = threading.Thread(target=swapper)
            clients = [threading.Thread(target=client, args=(w,))
                       for w in range(n_clients)]
            sw.start()
            for t in clients:
                t.start()
            for t in clients:
                t.join(2 * T)
                assert not t.is_alive()
            stop_swapping.set()
            sw.join(T)
            assert not sw.is_alive()
        checked = 0
        for w in range(n_clients):
            assert len(results[w]) == per_client  # every future resolved
            for i, logits in results[w]:
                ok = (np.array_equal(logits, want[0][i])
                      or np.array_equal(logits, want[1][i]))
                assert ok, f"torn logits for image {i}"
                checked += 1
        assert checked == n_clients * per_client
        assert reg.get("prod").version > 0  # swaps actually happened

    def test_request_after_swap_returns_is_answered_by_new_plan(self):
        reg = reference_registry(prod=tiny_model(0))
        imgs = images(6)
        want_new = plan_logits(tiny_model(1), imgs)
        with FleetEngine(reg, batch_size=4) as eng:
            eng.classify(imgs[:2], model="prod")
            assert reg.swap("prod", tiny_model(1)).version == 1
            got = [eng.submit(i, model="prod").result(T).logits for i in imgs]
        np.testing.assert_array_equal(np.stack(got), want_new)


# ---------------------------------------------------------------------------
# manifests + checkpoint versioning
# ---------------------------------------------------------------------------


class TestFleetManifest:
    def test_round_trip_and_relative_paths(self):
        with tempfile.TemporaryDirectory() as root:
            save_frozen(f"{root}/a", tiny_model(0))
            save_frozen(f"{root}/b", tiny_model(1))
            save_fleet_manifest(root, {"a": "a", "b": "b"},
                                splits={"s": {"a": 0.5, "b": 0.5}})
            manifest = load_fleet_manifest(root)
            assert manifest["splits"] == {"s": {"a": 0.5, "b": 0.5}}
            assert manifest["models"] == {"a": f"{root}/a", "b": f"{root}/b"}
            reg = ModelRegistry.from_manifest(root, device="cpu",
                                              backend="reference")
            assert reg.ids() == ["a", "b"]
            assert reg.get("a").plan.name == "tiny-0"
            assert reg.get("b").plan.backend == "reference"

    def test_manifest_validation(self):
        with tempfile.TemporaryDirectory() as root:
            with pytest.raises(ValueError, match="at least one model"):
                save_fleet_manifest(root, {})
            with pytest.raises(ValueError, match="unknown models"):
                save_fleet_manifest(root, {"a": "a"},
                                    splits={"s": {"ghost": 1.0}})
            with pytest.raises(ValueError, match="shadows"):
                save_fleet_manifest(root, {"a": "a"},
                                    splits={"a": {"a": 1.0}})
            with pytest.raises(FileNotFoundError):
                load_fleet_manifest(root)

    def test_hand_edited_manifest_rejected_at_load(self):
        with tempfile.TemporaryDirectory() as root:
            save_frozen(f"{root}/a", tiny_model(0))
            save_fleet_manifest(root, {"a": "a"})
            path = f"{root}/FLEET.json"
            with open(path) as f:
                meta = json.load(f)
            meta["splits"] = {"s": {"ghost": 1.0}}
            with open(path, "w") as f:
                json.dump(meta, f)
            with pytest.raises(ValueError, match="unknown models"):
                load_fleet_manifest(root)
            meta["format"] = "other"
            with open(path, "w") as f:
                json.dump(meta, f)
            with pytest.raises(ValueError, match="not a fleet manifest"):
                load_fleet_manifest(root)

    def test_save_frozen_appends_versions_and_pins_steps(self):
        fm0, fm1 = tiny_model(0), tiny_model(1)
        with tempfile.TemporaryDirectory() as d:
            save_frozen(d, fm0)
            save_frozen(d, fm1)  # auto-increments: does not clobber v0
            latest = load_frozen(d)
            pinned0 = load_frozen(d, step=0)
            assert torch.equal(latest.layers[0].w, fm1.layers[0].w)
            assert torch.equal(pinned0.layers[0].w, fm0.layers[0].w)
            assert latest.layers[0].w.dtype == torch.int8

    def test_prune_keeps_newest_versions(self):
        with tempfile.TemporaryDirectory() as d:
            for seed in range(4):
                save_frozen(d, tiny_model(seed))
            save_frozen(d, tiny_model(4), keep_last=2)  # prunes 0..2
            assert sorted(
                n for n in os.listdir(d) if n.startswith("step_")
            ) == ["step_00000003", "step_00000004"]
            latest = load_frozen(d)
            assert torch.equal(latest.layers[0].w, tiny_model(4).layers[0].w)
            with pytest.raises(ValueError, match="keep_last"):
                prune_frozen(d, keep_last=0)

    def test_auto_save_after_rollback_does_not_clobber(self):
        with tempfile.TemporaryDirectory() as d:
            for seed in range(3):
                save_frozen(d, tiny_model(seed))   # steps 0, 1, 2
            save_frozen(d, tiny_model(9), step=1)  # rollback: LATEST -> 1
            save_frozen(d, tiny_model(3))          # auto: 3, NOT 2
            assert torch.equal(load_frozen(d, step=2).layers[0].w,
                               tiny_model(2).layers[0].w)
            assert torch.equal(load_frozen(d).layers[0].w,
                               tiny_model(3).layers[0].w)

    def test_prune_never_deletes_the_step_latest_names(self):
        with tempfile.TemporaryDirectory() as d:
            save_frozen(d, tiny_model(0), step=5)
            save_frozen(d, tiny_model(1), step=3)  # rollback: LATEST -> 3
            assert prune_frozen(d, keep_last=1) == []  # 5 newest, 3 LATEST
            assert torch.equal(load_frozen(d).layers[0].w,
                               tiny_model(1).layers[0].w)


# ---------------------------------------------------------------------------
# registry-routed serving on a paper config
# ---------------------------------------------------------------------------


class TestFleetPaperConfig:
    def test_registry_routed_bit_exact_on_vgg8b(self):
        from repro_torch.core import les, prng

        cfg = tpaper.get("vgg8b", scale=0.0625)
        state = les.create_train_state(prng.PRNGKey(3), cfg, device="cpu")
        fm = freeze(state, cfg)  # freeze takes a TrainState, as JAX's does
        plan = compile_plan(fm, device="cpu", backend="reference")
        reg = ModelRegistry(device="cpu", backend="reference")
        reg.register("prod", fm)
        rng = np.random.default_rng(11)
        imgs = [rng.integers(-127, 128, cfg.input_shape).astype(np.int32)
                for _ in range(24)]
        with FleetEngine(reg, batch_size=8) as eng:
            fleet = np.stack([eng.submit(i, model="prod").result(T).logits
                              for i in imgs])
        with VisionEngine(plan, batch_size=8) as ve:
            vision = np.stack([f.result(T).logits
                               for f in [ve.submit(i) for i in imgs]])
        np.testing.assert_array_equal(fleet, vision)


# ---------------------------------------------------------------------------
# SLO attribution
# ---------------------------------------------------------------------------


class TestSlo:
    def test_slo_validation_and_units(self):
        slo = Slo(deadline_ms=50.0)
        assert slo.deadline_s == 0.05
        assert slo.slack_s(0.04) == pytest.approx(0.01)
        assert slo.slack_s(0.06) == pytest.approx(-0.01)
        with pytest.raises(ValueError, match="deadline"):
            Slo(deadline_ms=0)
        with pytest.raises(ValueError, match="deadline"):
            Slo(deadline_ms=-5)

    def test_slo_summary_with_and_without_objective(self):
        lats = [0.010] * 97 + [0.080] * 3
        out = slo_summary(lats, Slo(deadline_ms=50.0))
        assert out["p99_ms"] == pytest.approx(80.0)
        assert out["slo_ms"] == 50.0
        assert out["p99_slack_ms"] == pytest.approx(-30.0)
        assert out["slo_violations"] == 3
        assert out["violation_frac"] == pytest.approx(0.03)
        assert out["meets_slo"] is False
        ok = slo_summary([0.001] * 10, Slo(deadline_ms=50.0))
        assert ok["meets_slo"] is True and ok["slo_violations"] == 0
        bare = slo_summary(lats, None)
        assert bare["slo_ms"] is None and "meets_slo" not in bare

    def test_registry_threads_slo_through_lifecycle(self):
        reg = ModelRegistry(device="cpu", backend="reference")
        slo = Slo(deadline_ms=25.0)
        entry = reg.register("prod", tiny_model(0), slo=slo)
        assert entry.slo is slo
        reg.swap("prod", tiny_model(1))  # the objective belongs to the id
        assert reg.get("prod").slo is slo
        assert reg.snapshot()["prod"]["slo_ms"] == 25.0
        reg.set_slo("prod", None)
        assert reg.get("prod").slo is None
        assert reg.snapshot()["prod"]["slo_ms"] is None

    def test_fleet_attributes_deadline_per_request(self):
        reg = ModelRegistry(device="cpu", backend="reference")
        # generous deadline: every request makes it → 0 violations
        reg.register("prod", tiny_model(0), slo=Slo(deadline_ms=10_000.0))
        reg.register("free", tiny_model(1))  # no SLO: must not be counted
        with FleetEngine(reg, batch_size=4) as engine:
            futs = [engine.submit(img, model="prod") for img in images(12)]
            futs += [engine.submit(img, model="free") for img in images(4)]
            for f in futs:
                f.result(T)
            snap = engine.snapshot()
        assert snap["slo"] == {"prod": {
            "requests": 12, "violations": 0, "violation_frac": 0.0}}
        assert snap["models"]["prod"]["slo_ms"] == 10_000.0

    def test_fleet_counts_violations_against_tight_deadline(self):
        reg = ModelRegistry(device="cpu", backend="reference")
        # 1 µs deadline: physically unmeetable → everything violates
        reg.register("prod", tiny_model(0), slo=Slo(deadline_ms=0.001))
        with FleetEngine(reg, batch_size=4) as engine:
            for f in [engine.submit(img, model="prod") for img in images(8)]:
                f.result(T)
            slo_snap = engine.slo_snapshot()
        assert slo_snap["prod"] == {"requests": 8, "violations": 8,
                                    "violation_frac": 1.0}

    def test_no_slo_means_no_attribution(self):
        reg = ModelRegistry(device="cpu", backend="reference")
        reg.register("prod", tiny_model(0))
        with FleetEngine(reg, batch_size=4) as engine:
            for f in [engine.submit(img, model="prod") for img in images(4)]:
                f.result(T)
            assert engine.slo_snapshot() == {}
            assert engine.snapshot()["slo"] == {}
