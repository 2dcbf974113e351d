"""PyTorch port, ``repro_torch.obs.health``: the alert-rule semantics of
``tests/test_health.py`` on the port, and the port's monitor held against
the JAX package's.

  * edge triggering, hysteresis, severity escalation and window edges of
    every rule on handcrafted record streams (the counterparts of
    ``tests/test_health.py``);
  * the monitor's registry wiring, sinks and ``scan_jsonl`` ≡ the online
    feed;
  * the port's ``HealthMonitor`` over a JAX-written ``metrics.jsonl``
    (``tests/data/obs_top_metrics.jsonl``) fires the JAX monitor's alerts,
    ``Alert.to_json()`` equal and in order, with the same gauges.
"""

import json
import os

import pytest

from repro.obs import health as JH
from repro_torch.obs import health as H
from repro_torch.obs.metrics import MetricRegistry


def tensor(msb=10, sat8_frac=0.0, sat32_frac=0.0, max_abs=None):
    return {
        "msb": msb,
        "max_abs": (1 << msb) - 1 if max_abs is None else max_abs,
        "sat_int8_frac": sat8_frac,
        "sat_int32_frac": sat32_frac,
    }


def block_row(step, layer="block0", *, grad=None, act=None, dead_frac=0.0):
    return {
        "step": step, "layer": layer, "kind": "conv",
        "grad": grad or tensor(),
        "act": act or tensor(msb=7),
        "dead_frac": dead_frac,
    }


def opt_row(step, **scalars):
    return {"step": step, "layer": "_opt",
            **({"eta_inv_lr": 512} | scalars)}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


class TestPrimitives:
    def test_alert_json_and_format(self):
        a = H.Alert(rule="r", severity="critical", step=3, layer="block1",
                    signal="grad.msb", value=2.0, threshold=4.0,
                    message="boom")
        assert a.to_json()["severity"] == "critical"
        assert "[CRITICAL] step 3 block1 r: boom" == a.format()
        run_wide = H.Alert(rule="r", severity="info", step=0, layer="",
                           signal="s", value=0, threshold=0, message="m")
        assert "[INFO] step 0 r: m" == run_wide.format()

    def test_unknown_severity_rejected(self):
        with pytest.raises(ValueError, match="unknown severity"):
            H.SaturationTrendRule(severity="fatal")

    def test_window_must_be_positive(self):
        with pytest.raises(ValueError, match="window"):
            H.DeadUnitGrowthRule(window=0)

    def test_monotone_growth(self):
        assert H._is_monotone_growth([1, 1, 2])
        assert not H._is_monotone_growth([1, 1, 1])   # no net growth
        assert not H._is_monotone_growth([1, 3, 2])   # not monotone

    def test_group_steps_contiguous_and_restart(self):
        rows = [{"step": 1, "layer": "a"}, {"step": 1, "layer": "b"},
                {"step": 2, "layer": "a"}, {"step": 1, "layer": "a"}]
        groups = H.group_steps(rows)
        assert [s for s, _ in groups] == [1, 2, 1]
        assert sorted(groups[0][1]) == ["a", "b"]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


class TestSaturationTrendRule:
    def make(self, **kw):
        return H.SaturationTrendRule(
            field="sat_int8_frac", tensors=("act",), fire=0.2, clear=0.05,
            trend_fire=0.1, window=3, **kw)

    def test_hard_fire_is_edge_triggered_with_hysteresis(self):
        rule = self.make()
        fire = lambda frac, step: rule.observe(
            step, {"block0": block_row(step, act=tensor(sat8_frac=frac))})
        assert fire(0.1, 0) == []          # healthy
        fired = fire(0.3, 1)               # crosses the hard threshold
        assert [a.severity for a in fired] == ["warning"]
        assert fired[0].signal == "act.sat_int8_frac"
        assert fire(0.5, 2) == []          # still firing: silent
        assert fire(0.1, 3) == []          # below fire but above clear
        assert rule.active                 # ... so still active
        assert fire(0.04, 4) == []         # clears
        assert not rule.active
        assert len(fire(0.3, 5)) == 1      # re-armed: fires again

    def test_trend_fires_only_on_full_monotone_window(self):
        rule = self.make()
        obs = lambda frac, step: rule.observe(
            step, {"block0": block_row(step, act=tensor(sat8_frac=frac))})
        assert obs(0.11, 0) == []          # window not full
        assert obs(0.12, 1) == []
        fired = obs(0.13, 2)               # full + monotone + > trend_fire
        assert len(fired) == 1
        assert "rising monotonically" in fired[0].message

    def test_non_monotone_window_stays_quiet(self):
        rule = self.make()
        for step, frac in enumerate([0.11, 0.14, 0.12]):
            fired = rule.observe(step, {
                "block0": block_row(step, act=tensor(sat8_frac=frac))})
        assert fired == []

    def test_rows_without_the_field_are_skipped(self):
        rule = self.make()
        assert rule.observe(0, {"_opt": opt_row(0)}) == []


class TestHeadroomRule:
    def test_bad_thresholds_rejected(self):
        with pytest.raises(ValueError, match="critical_bits"):
            H.HeadroomRule(warn_bits=2, critical_bits=4, clear_bits=6)

    def test_warning_then_escalation_then_clear(self):
        rule = H.HeadroomRule(warn_bits=4, critical_bits=2, clear_bits=6)
        obs = lambda msb, step: rule.observe(
            step, {"block0": block_row(step, grad=tensor(msb=msb))})
        assert obs(20, 0) == []                      # 11 bits headroom
        fired = obs(28, 1)                           # 3 bits → warning
        assert [a.severity for a in fired] == ["warning"]
        assert fired[0].value == 3.0
        assert obs(28, 2) == []                      # active, silent
        fired = obs(30, 3)                           # 1 bit → escalates
        assert [a.severity for a in fired] == ["critical"]
        assert obs(28, 4) == []                      # 3 bits: not cleared
        assert rule.active
        assert obs(20, 5) == []                      # >= clear_bits: clears
        assert not rule.active


class TestDeadUnitGrowthRule:
    def test_monotone_growth_fires_warning(self):
        rule = H.DeadUnitGrowthRule(window=4, min_growth=0.1, ceiling=0.9)
        for step, d in enumerate([0.1, 0.15, 0.2]):
            assert rule.observe(step, {
                "block0": block_row(step, dead_frac=d)}) == []
        fired = rule.observe(3, {"block0": block_row(3, dead_frac=0.25)})
        assert [a.severity for a in fired] == ["warning"]
        assert "grew" in fired[0].message
        # growth stops under the ceiling → clears, then re-arms
        assert rule.observe(4, {
            "block0": block_row(4, dead_frac=0.2)}) == []
        assert not rule.active

    def test_ceiling_is_critical_even_without_growth(self):
        rule = H.DeadUnitGrowthRule(window=4, min_growth=0.1, ceiling=0.5)
        fired = rule.observe(0, {"block0": block_row(0, dead_frac=0.8)})
        assert [a.severity for a in fired] == ["critical"]
        assert "ceiling" in fired[0].message

    def test_growth_escalates_to_ceiling(self):
        rule = H.DeadUnitGrowthRule(window=3, min_growth=0.1, ceiling=0.6)
        stream = [0.2, 0.3, 0.45, 0.7]
        fired = []
        for step, d in enumerate(stream):
            fired += rule.observe(step, {
                "block0": block_row(step, dead_frac=d)})
        assert [a.severity for a in fired] == ["warning", "critical"]


class TestOptimizerStallRule:
    def test_fires_per_scalar_and_clears(self):
        rule = H.OptimizerStallRule(max_scalar=1 << 10)
        assert rule.observe(0, {"_opt": opt_row(0)}) == []
        fired = rule.observe(1, {"_opt": opt_row(1, eta_inv_lr=1 << 12,
                                                 gamma_inv_fw=1 << 11)})
        assert sorted(a.signal for a in fired) == [
            "opt.eta_inv_lr", "opt.gamma_inv_fw"]
        assert rule.observe(2, {"_opt": opt_row(
            2, eta_inv_lr=1 << 12, gamma_inv_fw=1 << 11)}) == []
        # restored-from-checkpoint run: scalar back down → clears
        assert rule.observe(3, {"_opt": opt_row(3)}) == []
        assert len(rule.active) == 1  # gamma_inv_fw absent → state kept

    def test_no_opt_row_is_a_noop(self):
        rule = H.OptimizerStallRule()
        assert rule.observe(0, {"block0": block_row(0)}) == []


class TestDpCompressFitRule:
    def test_fires_on_zero_and_clears_on_one(self):
        rule = H.DpCompressFitRule()
        dp = lambda fits, step: rule.observe(
            step, {"_dp": {"step": step, "layer": "_dp",
                           "grad_fits_int16": fits, "shards": 4}})
        assert dp(1, 0) == []
        fired = dp(0, 1)
        assert [a.rule for a in fired] == ["dp_compress_fit"]
        assert dp(0, 2) == []
        assert dp(1, 3) == []
        assert not rule.active

    def test_single_device_runs_have_no_dp_row(self):
        rule = H.DpCompressFitRule()
        assert rule.observe(0, {"block0": block_row(0)}) == []


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------


class TestHealthMonitor:
    def test_default_rules_cover_the_catalogue(self):
        names = {r.name for r in H.default_rules()}
        assert names == {"saturation[int32]", "saturation[int8]",
                         "headroom", "dead_units", "opt_scalar_stall",
                         "dp_compress_fit"}

    def test_counters_gauges_and_sinks(self):
        reg = MetricRegistry()
        seen = []
        mon = H.HealthMonitor(registry=reg, sinks=[seen.append])
        mon.observe_records([
            block_row(0, grad=tensor(msb=30)),       # headroom critical
            opt_row(0, eta_inv_lr=1 << 21),          # stall warning
            {"step": 0, "layer": "_dp", "grad_fits_int16": 1, "shards": 2},
        ])
        assert len(seen) == 2
        assert mon.steps_observed == 1
        crit = reg.counter("obs_alerts_total", labels=("rule", "severity"))
        assert crit.labels(rule="headroom", severity="critical").value == 1
        hdrm = reg.gauge("obs_headroom_bits", labels=("layer", "tensor"))
        assert hdrm.labels(layer="block0", tensor="grad").value == 1
        assert hdrm.labels(layer="block0", tensor="act").value == 24
        assert reg.gauge("dp_grad_fits_int16").value == 1
        active = reg.gauge("obs_alerts_active", labels=("rule",))
        assert active.labels(rule="headroom").value == 1
        assert active.labels(rule="dead_units").value == 0

    def test_active_alerts_sorted_most_severe_first(self):
        mon = H.HealthMonitor()
        mon.observe_records([
            block_row(0, grad=tensor(msb=28)),       # headroom warning
            opt_row(0, eta_inv_lr=1 << 21),          # stall warning
            block_row(0, layer="block1",
                      grad=tensor(msb=10, sat32_frac=0.01)),  # critical
        ])
        sevs = [a.severity for a in mon.active_alerts()]
        assert sevs == sorted(sevs, key=H.SEVERITIES.index, reverse=True)
        summary = mon.summary()
        assert summary["alerts_fired"] == 3
        assert summary["by_severity"]["critical"] == 1
        assert len(summary["active"]) == 3

    def test_registry_is_optional(self):
        mon = H.HealthMonitor(rules=[H.HeadroomRule()])
        fired = mon.observe_records([block_row(0, grad=tensor(msb=30))])
        assert len(fired) == 1

    def test_scan_jsonl_equals_online_feed(self, tmp_path, capsys):
        rows = []
        for step, (msb, dead) in enumerate(
                [(10, 0.0), (29, 0.1), (29, 0.2), (10, 0.1)]):
            rows.append(block_row(2 * step, grad=tensor(msb=msb),
                                  dead_frac=dead))
            rows.append(opt_row(2 * step))
        path = tmp_path / "metrics.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in rows))

        online = H.HealthMonitor()
        online.observe_records(rows)
        offline = H.scan_jsonl(str(path), sinks=[H.print_sink])
        assert ([a.to_json() for a in offline.alerts]
                == [a.to_json() for a in online.alerts])
        assert offline.summary() == online.summary()
        out = capsys.readouterr().out
        assert out.count("[alert]") == len(offline.alerts) > 0

    def test_jsonl_sink_appends_alert_rows(self, tmp_path):
        path = str(tmp_path / "alerts.jsonl")
        mon = H.HealthMonitor(sinks=[H.jsonl_sink(path)])
        mon.observe_records([block_row(0, grad=tensor(msb=31))])
        mon.observe_records([block_row(1, grad=tensor(msb=10)),
                             block_row(2, grad=tensor(msb=31))])
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        assert [r["step"] for r in rows] == [0, 2]
        assert all(r["rule"] == "headroom" for r in rows)


# ---------------------------------------------------------------------------
# the port's monitor ≡ the JAX package's
# ---------------------------------------------------------------------------

DATA = os.path.join(os.path.dirname(__file__), "data")
JAX_METRICS = os.path.join(DATA, "obs_top_metrics.jsonl")


class TestAgainstJax:
    def test_same_alerts_over_a_jax_written_jsonl(self):
        from repro.obs.metrics import MetricRegistry as JMetricRegistry

        treg, jreg = MetricRegistry(), JMetricRegistry()
        got = H.scan_jsonl(JAX_METRICS, registry=treg)
        want = JH.scan_jsonl(JAX_METRICS, registry=jreg)
        assert got.alerts, "the fixture run must fire alerts"
        assert [a.to_json() for a in got.alerts] == [a.to_json() for a in want.alerts]
        assert [a.to_json() for a in got.active_alerts()] == [
            a.to_json() for a in want.active_alerts()]
        assert got.summary() == want.summary()
        assert treg.json_snapshot() == jreg.json_snapshot()

    def test_scan_jsonl_equals_online_feed_on_the_jax_file(self):
        with open(JAX_METRICS) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        online = H.HealthMonitor()
        fired = []
        for step, group in H.group_steps(rows):  # one sampled step at a time
            fired += online.observe_records(list(group.values()))
        offline = H.scan_jsonl(JAX_METRICS)
        assert [a.to_json() for a in fired] == [a.to_json() for a in offline.alerts]
        assert offline.summary() == online.summary()

    def test_same_alert_stream_on_synthetic_steps(self):
        rows = []
        for step, (msb, dead, sat8) in enumerate(
                [(10, 0.0, 0.0), (28, 0.1, 0.2), (30, 0.2, 0.3), (29, 0.3, 0.3),
                 (20, 0.4, 0.05), (31, 0.95, 0.4)]):
            rows.append(block_row(step, grad=tensor(msb=msb),
                                  act=tensor(msb=7, sat8_frac=sat8), dead_frac=dead))
            rows.append(opt_row(step, eta_inv_lr=512 << (4 * step)))
        got, want = H.HealthMonitor(), JH.HealthMonitor()
        got.observe_records(rows)
        want.observe_records(rows)
        assert [a.to_json() for a in got.alerts] == [a.to_json() for a in want.alerts]
        assert len(got.alerts) >= 4
        assert [r.name for r in H.default_rules()] == [r.name for r in JH.default_rules()]
