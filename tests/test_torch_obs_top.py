"""PyTorch port, ``repro_torch.launch.obs_top``: the dashboard of
``tests/test_obs_top.py`` on the port, pinned by the same golden frame.

  * unit pieces: sparkline scaling, histogram-bucket quantile estimate,
    JSONL tail windowing, each ≡ the JAX package's;
  * the golden test: ``tests/data/obs_top_metrics.jsonl`` +
    ``obs_top_fleet.json`` render byte-identical to ``obs_top_frame.txt``,
    in-process and through ``python -m repro_torch.launch.obs_top --once``;
  * the port's frame ≡ the JAX package's on a run the port wrote.
"""

import json
import os
import subprocess
import sys

from repro.launch import obs_top as jobs_top
from repro_torch.launch import obs_top

DATA = os.path.join(os.path.dirname(__file__), "data")
METRICS = os.path.join(DATA, "obs_top_metrics.jsonl")
FLEET = os.path.join(DATA, "obs_top_fleet.json")
GOLDEN = os.path.join(DATA, "obs_top_frame.txt")


class TestPieces:
    def test_sparkline_zero_stays_blank(self):
        s = obs_top.sparkline([0, 1, 0, 1000])
        assert len(s) == 4
        assert s[0] == " " and s[2] == " "
        assert s[3] == obs_top.SPARK[-1]       # the max gets the full bar
        assert s[1] != " "                      # log scale: 1 still visible
        assert obs_top.sparkline([0, 0]) == "  "

    def test_quantile_from_buckets(self):
        buckets = [[0.01, 0], [0.1, 90], [1.0, 100], ["+Inf", 100]]
        assert obs_top.quantile_from_buckets(buckets, 100, 0.5) == 0.1
        assert obs_top.quantile_from_buckets(buckets, 100, 0.99) == 1.0
        assert obs_top.quantile_from_buckets(buckets, 0, 0.5) is None
        # rank past the last finite bound falls back to it
        tail = [[0.01, 0], ["+Inf", 10]]
        assert obs_top.quantile_from_buckets(tail, 10, 0.5) == 0.01

    def test_read_jsonl_tail_windows_by_step(self, tmp_path):
        path = tmp_path / "m.jsonl"
        rows = [{"step": s, "layer": "block0"} for s in range(10)]
        path.write_text("".join(json.dumps(r) + "\n" for r in rows))
        tail = obs_top.read_jsonl_tail(str(path), steps=3)
        assert sorted({r["step"] for r in tail}) == [7, 8, 9]

    def test_fleet_panel_without_serving_metrics(self):
        assert obs_top.render_fleet_panel({}) == [
            "fleet", "no serving metrics in snapshot"]


class TestGoldenFrame:
    def test_fixture_renders_byte_identical(self):
        with open(FLEET) as f:
            fleet = json.load(f)
        frame = obs_top.render_frame(METRICS, fleet)
        with open(GOLDEN) as f:
            golden = f.read()
        assert frame + "\n" == golden

    def test_frame_is_deterministic(self):
        with open(FLEET) as f:
            fleet = json.load(f)
        assert (obs_top.render_frame(METRICS, fleet)
                == obs_top.render_frame(METRICS, fleet))

    def test_frame_surfaces_the_run_state(self):
        frame = obs_top.render_frame(METRICS, None)
        assert "step 40" in frame
        assert "headroom" in frame and "CRITICAL" in frame
        assert "grads fit int16 limbs: NO" in frame
        # no fleet section without a snapshot
        assert "fleet" not in frame.splitlines()

    def test_empty_invocation_says_so(self):
        frame = obs_top.render_frame(None, None)
        assert "nothing to show" in frame


class TestCli:
    def test_once_subprocess_matches_golden(self):
        env = dict(os.environ)
        src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src, env.get("PYTHONPATH")) if p)
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.obs_top",
             "--metrics", METRICS, "--fleet-json", FLEET, "--once"],
            capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr
        with open(GOLDEN) as f:
            assert proc.stdout == f.read()


class TestAgainstJax:
    def test_pieces_match_jax(self):
        for counts in ([0, 1, 0, 1000], [0, 0], [5] * 33, list(range(33))):
            assert obs_top.sparkline(counts) == jobs_top.sparkline(counts)
        buckets = [[0.01, 0], [0.1, 90], [1.0, 100], ["+Inf", 100]]
        for q in (0.01, 0.5, 0.99, 1.0):
            assert (obs_top.quantile_from_buckets(buckets, 100, q)
                    == jobs_top.quantile_from_buckets(buckets, 100, q))
        with open(FLEET) as f:
            fleet = json.load(f)
        assert obs_top.render_fleet_panel(fleet) == jobs_top.render_fleet_panel(fleet)

    def test_frame_of_a_port_run_matches_jax(self, tmp_path):
        from repro_torch.launch.train import train_nitro

        path = str(tmp_path / "metrics.jsonl")
        train_nitro("mlp1", steps=3, batch=8, scale=0.05, device="cpu",
                    telemetry_every=1, telemetry_out=path)
        frame = obs_top.render_frame(path, None)
        assert frame == jobs_top.render_frame(path, None)
        assert "train health — step 2 (3 sampled step(s) in window)" in frame
