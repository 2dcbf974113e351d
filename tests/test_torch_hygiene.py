"""PyTorch port, hygiene: the port stands alone and never falls back.

  * no module of ``src/repro_torch`` (nor ``examples_torch/`` or
    ``chip_smoke.py``) imports ``jax`` or anything of the JAX package
    ``repro``;
  * importing the whole port leaves ``jax`` out of ``sys.modules``;
  * entry points default to CUDA and raise on a host without it;
  * ``chip_smoke.py`` fails, printing no result, without a card and
    outside a checkout.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
EXAMPLES = ROOT / "examples_torch"


def _forbidden(path: Path) -> list[str]:
    """Module names under jax/jaxlib/repro that ``path`` imports."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    return bad


def test_port_imports_no_jax_and_no_repro():
    files = sorted(PORT.rglob("*.py")) + sorted(EXAMPLES.rglob("*.py")) + [SMOKE]
    assert len(files) > 20
    for new in ("serving/fleet.py", "serving/registry.py", "serving/stats.py",
                "infer/export.py", "launch/serve_vision.py", "obs/__init__.py",
                "obs/metrics.py", "obs/trace.py", "obs/telemetry.py", "obs/health.py",
                "launch/obs_top.py", "train/fault_tolerance.py", "parallel/__init__.py",
                "parallel/dp.py", "parallel/collectives.py", "parallel/compress.py",
                "parallel/sharding.py", "parallel/tree.py", "kernels/autotune/__init__.py",
                "kernels/autotune/tiles.py", "kernels/autotune/measure.py",
                "kernels/autotune/cache.py", "kernels/autotune/state.py",
                "kernels/autotune/search.py", "core/fp_baselines.py",
                "kernels/int_matmul/int_matmul.py", "kernels/int_matmul/__init__.py",
                "models/config.py", "models/common.py", "models/attention.py",
                "models/mlp.py", "models/rwkv.py", "models/rglru.py",
                "models/transformer.py", "models/lm.py", "configs/llama3_2_1b.py",
                "train/optimizer.py", "train/trainer.py", "data/loader.py",
                "serving/engine.py", "launch/serve.py", "launch/mesh.py",
                "launch/shapes.py", "launch/op_analysis.py", "launch/dryrun.py",
                "parallel/pipeline.py", "core/cost_hook.py"):
        assert PORT / new in files
    for example in ("serve_cifar.py", "quickstart.py", "train_vgg8b.py", "les_transformer.py",
                    "serve_lm.py"):
        assert EXAMPLES / example in files
    bad = {str(f.relative_to(ROOT)): _forbidden(f) for f in files if _forbidden(f)}
    assert not bad, bad


def test_forbidden_import_scan_catches_offenders(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch\nfrom repro.core import numerics\n"
                 "import jax.numpy\nfrom . import repro\n")
    assert _forbidden(f) == ["repro.core", "jax.numpy"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, repro_torch.launch.serve_vision, repro_torch.launch.train\n"
        "import repro_torch.serving.fleet, repro_torch.serving.registry\n"
        "import repro_torch.obs, repro_torch.obs.telemetry, repro_torch.launch.obs_top\n"
        "import repro_torch.parallel.dp, repro_torch.parallel.collectives\n"
        "import repro_torch.parallel.compress, repro_torch.parallel.sharding\n"
        "import repro_torch.kernels.autotune, repro_torch.kernels.autotune.search\n"
        "import repro_torch.core.fp_baselines\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro'))\n"
        "print('LOADED', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device is usable")


def test_default_device_entry_points_raise(no_cuda):
    from repro_torch.configs import get_paper_config
    from repro_torch.core import model as M
    from repro_torch.core import prng
    from repro_torch.infer import compile_plan, freeze
    from repro_torch.launch import serve_vision

    cfg = get_paper_config("mlp1", scale=0.1)
    params = M.init_params(prng.PRNGKey(0), cfg, device="cpu")
    fm = freeze(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile_plan(fm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(prng.PRNGKey(0), cfg)
    tree = {"blocks": [{"fw": {"w": b["fw"]["w"].numpy()}, "lr": {"w": b["lr"]["w"].numpy()}}
                       for b in params["blocks"]],
            "output": {"w": params["output"]["w"].numpy()}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_vision.main(["--arch", "mlp1", "--scale", "0.1", "--requests", "1"])
    assert compile_plan(fm, device="cpu").logits(np.zeros((1, 784), np.int32)).shape == (1, 10)
    # the LM path's entry points default to the card too
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as lm_opt
    from repro_torch.train import trainer

    lm_cfg = get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.init_state(prng.PRNGKey(0), lm_cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(prng.PRNGKey(0), lm_cfg)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    host = (tree, lm_opt.AdamWState(mu=tree, nu=tree, count=np.int32(0)), np.int32(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.tree_from_numpy(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.state_from_numpy(host)
    assert trainer.state_from_numpy(host, device="cpu")[0]["w"].device.type == "cpu"
    assert trainer.init_state(prng.PRNGKey(0), lm_cfg, device="cpu")[2].device.type == "cpu"


def test_serving_control_plane_raises_without_cuda(no_cuda, tmp_path):
    """The registry and the fleet CLI default to the card, as every entry
    point does, and raise without one."""
    from repro_torch.configs import get_paper_config
    from repro_torch.core import model as M
    from repro_torch.core import prng
    from repro_torch.infer import freeze, save_fleet_manifest, save_frozen
    from repro_torch.launch import serve_vision
    from repro_torch.serving import ModelRegistry

    cfg = get_paper_config("mlp1", scale=0.1)
    fm = freeze(M.init_params(prng.PRNGKey(0), cfg, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry().register("a", fm)
    save_frozen(str(tmp_path / "a"), fm)
    save_fleet_manifest(str(tmp_path), {"a": "a"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry.from_manifest(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_vision.main(["--fleet-dir", str(tmp_path), "--requests", "1"])
    res = serve_vision.main(["--fleet-dir", str(tmp_path), "--requests", "2",
                             "--device", "cpu"])
    assert len(res["results"]) == 2


def test_train_entry_points_raise_without_cuda(no_cuda):
    """The trainer defaults to the card and raises on a host without one."""
    from repro_torch.configs import get_paper_config
    from repro_torch.core import les, prng
    from repro_torch.launch import train

    cfg = get_paper_config("vgg8b", scale=0.0625)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        les.create_train_state(prng.PRNGKey(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "vgg8b", "--steps", "1", "--scale", "0.0625"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train_nitro("vgg8b", steps=1, scale=0.0625)


def test_fp_baseline_entry_points_raise_without_cuda(no_cuda):
    """The FP baselines default to the card, as every entry point does, and
    raise without one; the examples' ``--device`` does too."""
    import runpy

    from repro_torch.configs import get_paper_config
    from repro_torch.core import fp_baselines as fp
    from repro_torch.core import prng

    cfg = get_paper_config("mlp1", scale=0.1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fp.init_fp_params(prng.PRNGKey(0), cfg)
    params = fp.init_fp_params(prng.PRNGKey(0), cfg, device="cpu")
    tree = {"blocks": [{k: b[k].numpy() for k in ("fw", "lr")} for b in params["blocks"]],
            "output": params["output"].numpy()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fp.fp_params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fp.adam_state_from_numpy((tree, tree, np.int32(0)))
    assert fp.fp_params_from_numpy(tree, device="cpu")["output"].device.type == "cpu"
    for example, argv in (("quickstart.py", []), ("train_vgg8b.py", ["--steps", "1"]),
                          ("les_transformer.py", ["--steps", "1"])):
        mod = runpy.run_path(str(EXAMPLES / example))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod["main"](argv)


def test_observability_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """Telemetry, metrics and tracing do not move a run off the card: the
    trainer and the serve CLI still raise without one, and open no server
    and write no file first."""
    from repro_torch.launch import serve_vision, train

    telem = tmp_path / "metrics.jsonl"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train_nitro("vgg8b", steps=1, scale=0.0625, telemetry_every=1,
                          telemetry_out=str(telem), metrics_port=0,
                          trace_out=str(tmp_path / "trace.jsonl"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "mlp1", "--steps", "1", "--telemetry-every", "1",
                    "--telemetry-out", str(telem), "--metrics-port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_vision.main(["--arch", "mlp1", "--scale", "0.1", "--requests", "1",
                           "--metrics-port", "0",
                           "--trace-out", str(tmp_path / "serve_trace.jsonl")])
    assert list(tmp_path.iterdir()) == []


def test_autotune_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """The autotuner measures on the card unless told otherwise: ``tune``
    and ``tune_training`` on the default device and ``--autotune`` in both
    CLIs raise without one, and write no cache first."""
    from repro_torch.configs import get_paper_config
    from repro_torch.kernels import autotune as at
    from repro_torch.launch import serve_vision, train

    cache = at.TileCache(str(tmp_path / "tile_cache.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        at.tune("matmul", (8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        at.tune_training(get_paper_config("vgg8b", scale=0.0625), 4, cache=cache)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "vgg8b", "--steps", "1", "--scale", "0.0625", "--autotune",
                    "--autotune-cache", cache.path])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train_nitro("mlp1", steps=1, scale=0.1, autotune=True,
                          autotune_cache=cache.path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_vision.main(["--arch", "mlp1", "--scale", "0.1", "--requests", "1",
                           "--autotune", "--autotune-cache", cache.path])
    assert list(tmp_path.iterdir()) == [] and at.active_cache() is None


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_chip_smoke_refuses_without_cuda(no_cuda):
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "CUDA is not available" in out.stderr


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "run it from the root of a checkout" in out.stderr
