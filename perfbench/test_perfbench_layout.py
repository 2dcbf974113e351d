"""BENCHMARK.json against the rules of its format (keys, names, units,
bounds, cells on four cards), and every name in it against the files the
harness finds by that name."""

from __future__ import annotations

import ast
import json
import re
import shutil
import sys
import time
import types

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
    work = drv.cell_work(c.config, c.traffic)
    assert work["entries"]
    assert context.cell_work(c.config, c.traffic) == work


PINNED = harness.load_json(harness.BENCH_DIR / "cell_work.pinned.json")


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_cell_work_is_pinned(cell):
    """Each cell's counts, as its driver gives them, equal the ones the
    harness gave before the drivers owned them, whole."""
    c = harness.resolve(cell)
    got = json.loads(json.dumps(context.cell_work(c.config, c.traffic)))
    assert got == PINNED[cell]
    # 2 x the multiply-adds an image worked out by hand (test_perfbench_work.py)
    macs = {"vgg8b": 949_364_736, "vgg11b": 1_402_349_568}[c.config["name"]]
    assert got["infer_ops_per_image"] == 2 * macs


#: Keys of a NITRO-D block net's configuration and its traffic's batch.
BLOCK_NET_KEYS = ("blocks", "input_shape", "num_classes", "p_c", "p_l", "d_lr", "alpha_inv",
                  "kernel_size", "gamma_inv", "gamma_inv_batch", "eta_fw", "eta_lr", "batch")
COMMON_PATH = {"run.py": None, "context.py": None,
               "harness.py": ("Cell", "resolve", "driver", "metric_reader", "quantity",
                              "result_line", "finish", "emit", "card_info", "correct")}


@pytest.mark.parametrize("name", sorted(COMMON_PATH))
def test_common_path_reads_no_key_of_a_block_net(name):
    """The frame every cell runs through names no key of a block net: a
    configuration of another kind needs a driver, not an edit here."""
    src = (harness.BENCH_DIR / name).read_text()
    tree = ast.parse(src)
    parts = [src] if COMMON_PATH[name] is None else [
        ast.get_source_segment(src, n) for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name in COMMON_PATH[name]]
    assert COMMON_PATH[name] is None or len(parts) == len(COMMON_PATH[name])
    strings = {n.value for part in parts for n in ast.walk(ast.parse(part))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert not strings & set(BLOCK_NET_KEYS), (name, strings & set(BLOCK_NET_KEYS))


def _toy_lm_driver():
    """A driver of a traffic kind the benchmark does not have, as a later
    configuration would bring one: a toy language model's forward pass
    from the seed, checked against the same product in float64."""
    mod = types.ModuleType("perfbench.drivers.toy_lm_train")

    def cell_work(config, traffic, scale=1.0):
        tokens = traffic["batch"] * traffic["seq"]
        return {"tokens_per_step": tokens,
                "flops_per_step": 2 * tokens * config["d_model"] * config["vocab_size"]}

    def run(ctx):
        cfg, tr = ctx.config, ctx.traffic
        gen = torch.Generator().manual_seed(ctx.seed)
        emb = torch.randn(cfg["vocab_size"], cfg["d_model"], generator=gen)
        ids = torch.randint(0, cfg["vocab_size"], (tr["batch"], tr["seq"]), generator=gen)
        t0 = time.perf_counter()
        logits = emb[ids] @ emb.T
        wall = time.perf_counter() - t0
        want = emb.double()[ids] @ emb.double().T
        gap = float((logits.double() - want).abs().max())
        tokens = ctx.work["tokens_per_step"]
        return harness.Outcome(
            e2e={"setup_s": t0 - ctx.t_start, "lm_tokens_per_s": tokens / max(wall, 1e-9),
                 "peak_mem_gib": 0.0},
            readings={"kind": "toy_lm_train", "tokens": tokens}, checks={"logit_gap": (gap, 1e-3)},
            attempted=1, failed=0, memory_peak_bytes=0, trace=None)

    mod.cell_work, mod.run = cell_work, run
    return mod


def test_a_config_of_another_kind_needs_only_new_files(tmp_path, monkeypatch):
    """A configuration with a language model's keys and none of a block
    net's, a traffic mix of a new kind whose driver module the test
    supplies, a cell, an end-to-end metric and a per-layer reader, added as
    files and entries alone, resolved, run and reported through the common
    path, with no file under ``perfbench/`` edited."""
    before = {p: p.read_bytes() for p in harness.BENCH_DIR.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    base = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "metrics"):
        (base / sub).mkdir(parents=True)
    cfg = {"name": "toy_lm", "source": "test", "reduced": [], "d_model": 32, "layers": 2,
           "heads": 4, "kv_heads": 2, "vocab_size": 96, "rope_theta": 500000.0}
    (base / "configs" / "toy_lm.json").write_text(json.dumps(cfg))
    (base / "traffic" / "lm.toy.json").write_text(
        json.dumps({"kind": "toy_lm_train", "batch": 3, "seq": 8}))
    (base / "metrics" / "tokens_seen.toy.py").write_text(
        "def read(r, trace):\n    return float(r['tokens']) if r['kind'] == 'toy_lm_train' else None\n")
    monkeypatch.setitem(sys.modules, "perfbench.drivers.toy_lm_train", _toy_lm_driver())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy_lm", "source": "test", "reduced": [], "why": "test",
                             "file": "perfbench/configs/toy_lm.json"})
    bench["workloads"].append({"name": "toy_lm.train", "config": "toy_lm", "traffic": "lm.toy",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "lm_tokens_per_s", "unit": "tokens/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["toy_lm.train"]})
    bench["per_layer"].append({"name": "tokens_seen.toy", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "lm_tokens_per_s", "workloads": ["toy_lm.train"]})

    cell = harness.resolve("toy_lm.train", bench, base)
    assert not set(cell.config) & set(BLOCK_NET_KEYS)
    ctx = context.Context.for_cell(cell, seed=2 ** 31 + 11, seconds=0.1, trace=True,
                                   device=torch.device("cpu"), t_start=time.perf_counter())
    assert ctx.work == {"tokens_per_step": 24, "flops_per_step": 2 * 24 * 32 * 96}
    out = harness.driver(cell.traffic["kind"]).run(ctx)
    device = {"platform": "gpu", "kind": "test", "count": 1}
    traced = harness.result_line(cell, out, True, device)
    assert traced["metrics"] == {"tokens_seen.toy": {"value": 24.0, "unit": "count"}}
    line = harness.result_line(cell, out, False, device)
    assert set(line["metrics"]) == {"lm_tokens_per_s", "peak_mem_gib", "setup_s"}
    assert line["correct"] and list(line)[-1] == "checks"
    assert {p: p.read_bytes() for p in before} == before


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
