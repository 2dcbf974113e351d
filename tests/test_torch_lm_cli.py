"""PyTorch port, the LM trainer (``launch.train.train_lm`` and the CLI's
``--arch <LM id>``, ``--seq``, ``--les-groups``) ≡ the JAX launcher's
``train_lm``, on the CPU: the same lines printed, numbers within the
tolerance below; the flags reaching the config; the checkpoint in the
JAX format, leaf for leaf, read by either package; a resume from a JAX
checkpoint; and the entry points raising without a card.

Tolerances: both runs start from their own ``init_state(PRNGKey(0))``,
whose draws differ by at most ``INIT_TOL`` (``test_torch_lm_models.py``),
and compute in bf16.  ε is the port's rounding level (a float64 run of
the first step's gradient, ``tests/_torch_lm.py``): each printed loss lies
within ε of JAX's (relative), each grad norm within 3 ε; each saved
parameter within INIT_TOL of its leaf's largest value plus 2.01 · Σ lr
(AdamW moves a coordinate at most about lr a step), each saved AdamW mu
within 3 ε and nu within 6 ε of JAX's, relative to the leaf's largest
value (mu is linear in the gradients, nu quadratic).
"""

import io
import re
import shutil
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from _torch_lm import ADAM_PART, MU_LEVELS, NU_LEVELS, dev, make_batch, rounding_level
from repro.launch import train as jtrain
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.launch import train as ttrain
from repro_torch.train import checkpoint as tckpt
from repro_torch.parallel.tree import leaves
from repro_torch.train import trainer as ttr

INIT_TOL = 2.0 ** -16
ARGS = dict(steps=3, batch=2, seq=16)
NUM = re.compile(r"-?\d+\.\d+")


def _run(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _eps() -> float:
    cfg = get_smoke_config("llama3.2-1b")
    state = ttr.init_state(prng.PRNGKey(0), cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    _, g = ttr.value_and_grad(state[0], cfg, b)
    return rounding_level(state[0], cfg, b, g)


def _same_printout(got: str, want: str, eps: float) -> None:
    """Line for line the same text; losses within ε, grad norms 3 ε."""
    gl, wl = got.strip().splitlines(), want.strip().splitlines()
    assert [NUM.sub("#", line) for line in gl] == [NUM.sub("#", line) for line in wl]
    for g, w in zip(gl, wl):
        for i, (a, b) in enumerate(zip(NUM.findall(g), NUM.findall(w))):
            scale = 3 * eps if "gnorm" in g and i == 1 else eps
            assert abs(float(a) - float(b)) <= scale * max(abs(float(b)), 1.0), (g, w)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX launcher and the port's CLI, 3 steps with checkpoints, then a
    resume of each from the JAX checkpoint (the port's from a copy)."""
    root = tmp_path_factory.mktemp("lm_cli")
    jdir, tdir, rdir = root / "jax", root / "port", root / "port_resume"
    j1, jout1 = _run(jtrain.train_lm, "llama3.2-1b", scale=1.0, ckpt_dir=str(jdir), **ARGS)
    t1, tout1 = _run(ttrain.main, ["--arch", "llama3.2-1b", "--steps", "3", "--batch", "2",
                                   "--seq", "16", "--ckpt-dir", str(tdir), "--device", "cpu"])
    shutil.copytree(jdir, rdir)
    j2, jout2 = _run(jtrain.train_lm, "llama3.2-1b", scale=1.0, ckpt_dir=str(jdir), **ARGS)
    t2, tout2 = _run(ttrain.train_lm, "llama3.2-1b", ckpt_dir=str(rdir), device="cpu", **ARGS)
    return dict(jdir=jdir, tdir=tdir, rdir=rdir, t1=t1, t2=t2, j1=j1, j2=j2,
                out=(jout1, tout1, jout2, tout2), eps=_eps())


def test_cli_printout_matches_jax(runs):
    jout1, tout1, jout2, tout2 = runs["out"]
    _same_printout(tout1, jout1, runs["eps"])
    assert "[restore]" not in tout1
    _same_printout(tout2, jout2, runs["eps"])
    assert "[restore] resumed from step 3" in tout2


def _params_within(got_dir, want_dir, step, lrs, init_tol, eps):
    """Every parameter leaf at ``step`` within init_tol of its largest value
    plus ADAM_PART · Σ lrs; AdamW's mu within MU_LEVELS · ε and nu within
    NU_LEVELS · ε of JAX's (relative to the leaf's largest value); the
    counters equal."""
    paths = [e["path"] for e in _manifest(want_dir, step)["leaves"]]
    seen = set()
    for path, a, b in zip(paths, _leaves_at(got_dir, step), _leaves_at(want_dir, step)):
        kind = path.split("/")[0] if path.startswith("[0]") else path[:7]
        seen.add(kind)
        if kind == "[0]":
            bound = init_tol * np.abs(b).max() + ADAM_PART * sum(lrs)
            assert np.abs(a - b).max() <= bound, path
        elif kind in ("[1]/.mu", "[1]/.nu"):
            levels = MU_LEVELS if kind == "[1]/.mu" else NU_LEVELS
            assert dev(a, b) <= levels * eps, (path, dev(a, b), eps)
        elif path in ("[1]/.count", "[2]"):
            assert a == b, path
    assert {"[0]", "[1]/.mu", "[1]/.nu"} <= seen, seen


def test_checkpoint_matches_jax_leaf_for_leaf(runs):
    """The port's checkpoint: JAX's manifest (paths, shapes, dtypes, step),
    read back bitwise by JAX's ``restore``, its params within the bound."""
    tm, jm = _manifest(runs["tdir"], 3), _manifest(runs["jdir"], 3)
    assert tm["status"] == "COMPLETE" and tm["step"] == jm["step"] == 3
    assert [(e["path"], e["shape"], e["dtype"]) for e in tm["leaves"]] == \
        [(e["path"], e["shape"], e["dtype"]) for e in jm["leaves"]]
    jstate, step = jckpt.restore(str(runs["tdir"]), _jax_template(), step=3)
    assert step == 3
    for a, b in zip(jax.tree.leaves(jstate), _leaves_at(runs["tdir"], 3)):
        np.testing.assert_array_equal(np.asarray(a, np.float64), b)
    lrs = [float(m["lr"]) for m in runs["t1"]["step_metrics"]]
    assert lrs[0] == 0.0
    _params_within(runs["tdir"], runs["jdir"], 3, lrs, INIT_TOL, runs["eps"])


def test_resume_from_a_jax_checkpoint(runs):
    """The port resumes from (a copy of) JAX's step-3 checkpoint: the state
    restored bitwise, the lr schedule going on from step 3, and after 3
    more steps, saved at step 6, every param within 2.01 · Σ lr of JAX's
    own resumed run (both start from the same state)."""
    restored, step = tckpt.restore(str(runs["jdir"]), runs["t2"]["state"], step=3)
    assert step == 3 and runs["t2"]["start_step"] == 3
    for a, b in zip(leaves(restored[0]), _leaves_at(runs["jdir"], 3)):
        np.testing.assert_array_equal(a.double().numpy(), b)
    assert tckpt.latest_step(str(runs["rdir"])) == jckpt.latest_step(str(runs["jdir"])) == 6
    lrs = [float(m["lr"]) for m in runs["t2"]["step_metrics"]]
    assert lrs[0] > 0.0
    _params_within(runs["rdir"], runs["jdir"], 6, lrs, 0.0, runs["eps"])


def _manifest(ckpt_dir, step):
    import json

    return json.loads((ckpt_dir / f"step_{step:08d}" / "MANIFEST.json").read_text())


def _leaves_at(ckpt_dir, step):
    d = ckpt_dir / f"step_{step:08d}"
    return [np.load(d / e["file"]).astype(np.float64) for e in _manifest(ckpt_dir, step)["leaves"]]


def _jax_template():
    from repro.configs import get_smoke_config as jget
    from repro.train import trainer as jtr

    return jtr.init_state(jax.random.PRNGKey(0), jget("llama3.2-1b"))


def test_les_groups_and_seq_flags():
    """``--les-groups 2`` trains 2 local-loss groups over at least 4 layers
    (JAX's launcher's rule) and ``--seq`` sets the sequence length: the
    run's config and metrics say so (the LES path itself is held against
    JAX in ``test_torch_lm_train*.py``)."""
    res, out = _run(ttrain.main, ["--arch", "llama3.2-1b", "--steps", "1", "--batch", "2",
                                  "--seq", "8", "--les-groups", "2", "--device", "cpu"])
    cfg = res["config"]
    assert (cfg.les_groups, cfg.num_layers, cfg.scan_repeats) == (2, 4, 4)
    assert "les" in res["step_metrics"][0] and "step    0" in out


def test_lm_entry_points_raise_without_cuda(no_cuda):
    """The LM trainer runs on the card unless asked for the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "llama3.2-1b", "--steps", "1", "--batch", "2", "--seq", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train_lm("qwen3-32b", steps=1, batch=2, seq=8)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
