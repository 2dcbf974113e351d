"""PyTorch port, the train CLI's data parallelism ≡ the JAX launcher's.

The same flags through both launchers: ``--arch vgg8b --scale 0.0625
--steps 2 --batch 8 --num-devices 2 --dp-reduce ring --telemetry-every 1``.
The JAX launcher re-execs itself onto two host devices (a subprocess,
started first); the port spawns two gloo ranks on the CPU.  Rank 0's
``metrics.jsonl`` is the JAX launcher's byte for byte, ``_dp`` rows
included, and its ``dp_compress_fit`` alert fires at the same step with
the same message; the port's two-rank run is its one-device run bit for
bit.  (A two-rank resume from ``--ckpt-dir`` is in ``test_torch_dp.py``.)
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train as ttrain

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--arch", "vgg8b", "--scale", "0.0625", "--steps", "2", "--batch", "8",
         "--telemetry-every", "1"]
DP_FLAGS = ["--num-devices", "2", "--dp-reduce", "ring"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_cli")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    env.pop("XLA_FLAGS", None)  # the launcher sets its own device count
    jax_cli = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *FLAGS, *DP_FLAGS,
         "--telemetry-out", str(d / "jax.jsonl"), "--alerts-out", str(d / "jax_alerts.jsonl")],
        env=env, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        got = ttrain.main([*FLAGS, *DP_FLAGS, "--device", "cpu",
                           "--telemetry-out", str(d / "torch.jsonl"),
                           "--alerts-out", str(d / "torch_alerts.jsonl")])
        one = ttrain.main([*FLAGS, "--device", "cpu",
                           "--telemetry-out", str(d / "one.jsonl")])
        jax_out, _ = jax_cli.communicate(timeout=600)
    finally:
        if jax_cli.poll() is None:
            jax_cli.kill()
            jax_cli.communicate()
    assert jax_cli.returncode == 0, jax_out
    return d, got, one, jax_out


def test_dp_metrics_jsonl_is_jax_byte_for_byte(runs):
    d, *_ = runs
    data = (d / "torch.jsonl").read_bytes()
    assert data == (d / "jax.jsonl").read_bytes()
    dp_rows = [json.loads(ln) for ln in data.decode().splitlines() if '"_dp"' in ln]
    assert [(r["step"], r["shards"]) for r in dp_rows] == [(0, 2), (1, 2)]
    assert all(r["grad_fits_int16"] in (0, 1) for r in dp_rows)


def test_dp_compress_fit_alert_is_jax_byte_for_byte(runs):
    d, got, _, jax_out = runs
    data = (d / "torch_alerts.jsonl").read_bytes()
    assert data == (d / "jax_alerts.jsonl").read_bytes()
    alerts = [json.loads(ln) for ln in data.decode().splitlines()]
    fit = [a for a in alerts if a["rule"] == "dp_compress_fit"]
    assert fit and fit[0]["step"] == 0
    assert f"step 0 dp_compress_fit: {fit[0]['message']}" in jax_out
    assert got["health"]["alerts_fired"] == len(alerts)


def test_dp_result_matches_the_jax_launcher(runs):
    _, got, _, jax_out = runs
    done = re.search(r"\[done\] test accuracy (\S+) over (\d+) samples", jax_out)
    assert done and f"{got['test_accuracy']:.4f}" == done.group(1)
    step0 = re.search(r"step +0 +loss=(\d+) +scaled=(\S+) +correct=(\d+)/8", jax_out)
    m0 = got["step_metrics"][0]
    assert step0 and int(m0.loss) == int(step0.group(1))
    assert int(m0.correct) == int(step0.group(3))
    assert got["steps"] == 2 and got["start_step"] == 0


def test_dp_run_is_the_one_device_run(runs):
    """Two ranks ≡ one device: final state, every step's metrics, the test
    accuracy and the telemetry rows, bitwise; rank 0's tensors come back
    on the host."""
    d, got, one, _ = runs
    from repro_torch.parallel import tree

    a = tree.leaves((got["state"], got["step_metrics"]))
    b = tree.leaves((one["state"], one["step_metrics"]))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and x.dtype == y.dtype and torch.equal(x, y)
    assert got["test_accuracy"] == one["test_accuracy"]
    assert got["scaled_loss"] == one["scaled_loss"]
    rows = [ln for ln in (d / "torch.jsonl").read_text().splitlines() if '"_dp"' not in ln]
    assert rows == (d / "one.jsonl").read_text().splitlines()


def test_dp_cli_rejections(tmp_path):
    with pytest.raises(ValueError, match="divide evenly"):
        ttrain.train_nitro("vgg8b", steps=1, batch=7, scale=0.0625, device="cpu",
                           num_devices=2)
    with pytest.raises(ValueError, match="dp_reduce"):
        ttrain.train_nitro("vgg8b", steps=1, batch=8, scale=0.0625, device="cpu",
                           num_devices=2, dp_reduce="avg")
    with pytest.raises(SystemExit):
        ttrain.main([*FLAGS, "--device", "cpu", *DP_FLAGS[:2], "--dp-reduce", "avg"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.main([*FLAGS, *DP_FLAGS])
