"""BENCHMARK.json against the rules of its format (keys, names, units,
bounds, cells on four cards), and every name in it against the files the
harness finds by that name."""

from __future__ import annotations

import json
import re
import shutil
import time

import pytest
import torch

from perfbench import context, harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        c = harness.resolve(cell)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in names, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    drv = harness.driver(c.traffic["kind"])
    assert callable(drv.run)
    work = context.cell_work(c.config, c.traffic)
    assert work["entries"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_resolves_to_its_reader(metric):
    assert callable(harness.metric_reader(metric).read)


def test_config_files_are_the_configs_entries():
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_a_new_config_traffic_and_metric_need_only_new_files(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    added as files and entries alone, run end to end (on the CPU, tiny)."""
    base = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.BENCH_DIR / sub, base / sub)
    cfg = harness.load_json(base / "configs" / "vgg8b.json")
    cfg.update(name="tiny_cnn", input_shape=[8, 8, 3],
               blocks=[{"kind": "conv", "out": 8, "pool": True},
                       {"kind": "linear", "out": 16}])
    (base / "configs" / "tiny_cnn.json").write_text(json.dumps(cfg))
    traffic = dict(harness.load_json(base / "traffic" / "train.b512.json"),
                   batch=4, dataset_images=12)
    (base / "traffic" / "train.tiny.json").write_text(json.dumps(traffic))
    (base / "metrics" / "steps_seen.tiny.py").write_text(
        "def read(r, trace):\n    return float(r['steps'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny_cnn", "source": "test", "reduced": [], "why": "test",
                             "file": "perfbench/configs/tiny_cnn.json"})
    bench["workloads"].append({"name": "tiny_cnn.train", "config": "tiny_cnn",
                               "traffic": "train.tiny", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "vgg8b.train.b512" in m["workloads"]:
            m["workloads"].append("tiny_cnn.train")
    bench["per_layer"].append({"name": "steps_seen.tiny", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "step",
                               "moves": "train_images_per_s", "workloads": ["tiny_cnn.train"]})
    cell = harness.resolve("tiny_cnn.train", bench, base)
    assert [m["name"] for m in cell.per_layer][-1] == "steps_seen.tiny"
    ctx = context.Context.for_cell(cell, seed=3, seconds=0.2, trace=False,
                                   device=torch.device("cpu"), t_start=time.perf_counter())
    out = harness.driver(cell.traffic["kind"]).run(ctx)
    assert harness.correct(out.checks)
    reader = harness.metric_reader("steps_seen.tiny", base)
    assert reader.read(out.readings, None) == out.attempted
