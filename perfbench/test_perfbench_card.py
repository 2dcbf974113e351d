"""The benchmark's command on the card: each one-card cell runs a short
window and comes out ``correct`` with its metrics.  Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import harness

ONE_CARD = [w["name"] for w in harness.benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ONE_CARD)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cuda_card, cell, trace):
    out = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    c = harness.resolve(cell)
    want = c.per_layer if trace else c.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
