"""PyTorch port, LM serving end to end (``serving/engine.py``
``Engine`` / ``Request``, ``launch/serve.py``, ``examples_torch/serve_lm.py``)
≡ the JAX package's, on the CPU.

  * the Engine in float32: for the eight token archs, ragged prompts (3, 5
    and 9 tokens, left-padded), per-request ``max_new_tokens`` and one
    request stopped by its ``eos_id``: the port's token lists equal JAX's,
    from the same params (the port's ``init_params(PRNGKey(0))``);
  * qwen2-vl and whisper: JAX's ``Engine.generate`` raises ``KeyError``
    ('embeds', 'enc_embeds': its prefill reads inputs that the Engine does
    not pass), and so does the port's;
  * ``python -m repro_torch.launch.serve`` at its defaults (llama3.2-1b,
    and ``--arch rwkv6-3b``) and ``examples_torch/serve_lm.py`` print the
    JAX launcher's and example's lines byte for byte, each package from its
    own init, at the config's own dtype (bf16);
  * the Engine and the CLI raise without a card unless the CPU is asked
    for.

Where a token differs, JAX's top-2 margin at that step must lie within the
logit tolerance (``tests/_torch_lm_serve.py``: ε is the port's prefill
against its float64 run on the same prompts); the test then reports the
near tie as a warning and compares that request no further.  Otherwise it
fails.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_serve import port_prefill, rounding_level, same_tokens
from repro.configs import get_smoke_config as jget
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs import list_archs
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as T
from repro_torch.parallel.tree import tree_map
from repro_torch.serving import Engine, Request

ROOT = Path(__file__).resolve().parents[1]
EMBED_ARCHS = {"qwen2-vl-72b": "embeds", "whisper-large-v3": "enc_embeds"}
TOKEN_ARCHS = [a for a in list_archs() if a not in EMBED_ARCHS]
#: the Engine case: prompt lengths, max_new_tokens, and the request that
#: stops on an EOS id (the port's third token for it, found by a first run)
LENGTHS, MAX_NEW, EOS_REQUEST = (5, 9, 3), (8, 6, 8), 1


@contextlib.contextmanager
def jax_logits():
    """Record the logits of JAX's Engine at each step (its prefill's, then
    each decode step's), as numpy."""
    record, real_prefill, real_init = [], jlm.prefill, jengine.Engine.__init__

    def prefill(*a, **kw):
        logits, cache = real_prefill(*a, **kw)
        record.append(np.asarray(logits))
        return logits, cache

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        decode = self._decode

        def rec(p, t, c):
            logits, cache = decode(p, t, c)
            record.append(np.asarray(logits))
            return logits, cache

        self._decode = rec

    jlm.prefill, jengine.Engine.__init__ = prefill, init
    try:
        yield record
    finally:
        jlm.prefill, jengine.Engine.__init__ = real_prefill, real_init


def _padded(prompts) -> np.ndarray:
    """The Engine's left-padded prompt batch."""
    n = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), n), np.int32)
    for i, p in enumerate(prompts):
        out[i, n - len(p):] = p
    return out


def _eps(params, cfg, prompts, max_seq: int) -> float:
    """The port's prefill rounding level on the Engine's prompt batch."""
    batch = {"tokens": _padded(prompts)}
    pl, pc = port_prefill(params, cfg, batch, max_seq)
    pl64, pc64 = port_prefill(params, cfg, batch, max_seq, f64=True)
    return rounding_level([pl], pc, [pl64], pc64)


def _f32(arch):
    return (dataclasses.replace(jget(arch), dtype=jnp.float32),
            dataclasses.replace(tget(arch), dtype=torch.float32))


def _requests(cls, prompts, eos=None):
    return [cls(prompt=list(p), max_new_tokens=n,
                eos_id=eos if i == EOS_REQUEST else None)
            for i, (p, n) in enumerate(zip(prompts, MAX_NEW))]


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_engine_tokens_match_jax(arch):
    jc, tc = _f32(arch)
    params = T.init_params(prng.PRNGKey(0), tc, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), params))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tc.vocab_size, n).tolist() for n in LENGTHS]
    engine = Engine(tc, params, max_seq=64, device="cpu")
    eos = engine.generate(_requests(Request, prompts))[EOS_REQUEST].generated[2]
    got = engine.generate(_requests(Request, prompts, eos))
    with jax_logits() as logits:
        want = jengine.Engine(jc, jp, max_seq=64).generate(
            _requests(jengine.Request, prompts, eos))
    assert want[EOS_REQUEST].generated[-1] == eos
    assert len(want[EOS_REQUEST].generated) < MAX_NEW[EOS_REQUEST]
    assert all(r.done for r in got) and len(engine.step_s) == len(logits)
    same_tokens([r.generated for r in got], [r.generated for r in want], logits,
                lambda: _eps(params, tc, prompts, 64), f"{arch} Engine f32")


@pytest.mark.parametrize("arch", sorted(EMBED_ARCHS))
def test_engine_embed_archs_raise_as_jax(arch):
    """JAX's Engine passes only tokens, so its prefill raises KeyError for
    the stub-frontend archs; the port keeps that behaviour."""
    prompts = [[1, 2, 3]]
    jc, tc = jget(arch), tget(arch)
    params = T.init_params(prng.PRNGKey(0), tc, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), params))
    with pytest.raises(KeyError) as want:
        jengine.Engine(jc, jp).generate(_requests(jengine.Request, prompts))
    with pytest.raises(KeyError) as got:
        Engine(tc, params, device="cpu").generate(_requests(Request, prompts))
    assert got.value.args == want.value.args == (EMBED_ARCHS[arch],)


def _run(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _same_printout(got: str, want: str, logits: list, eps, what: str) -> None:
    """The same lines, each ``... → [tokens]`` list compared by
    ``same_tokens`` (which allows a near tie; ``eps`` gives its ε); the
    text around the lists equal byte for byte."""
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl), (got, want)
    toks = [(i, g, w) for i, (g, w) in enumerate(zip(gl, wl)) if "[" in w]
    for i, g, w in zip(range(len(gl)), gl, wl):
        if "[" not in w:
            assert g == w, (what, g, w)
    for _, g, w in toks:
        assert g.split("[")[0].split(":")[0] == w.split("[")[0].split(":")[0], (g, w)
    got_lists = [ast.literal_eval(g[g.rindex("["):]) for _, g, _ in toks]
    want_lists = [ast.literal_eval(w[w.rindex("["):]) for _, _, w in toks]
    if got != want:
        assert same_tokens(got_lists, want_lists, logits, eps, what) > 0
        for (_, g, w), gt, wt in zip(toks, got_lists, want_lists):
            if gt == wt:
                assert g == w, (what, g, w)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-3b"])
def test_cli_printout_matches_jax(arch, monkeypatch):
    argv = [] if arch == "llama3.2-1b" else ["--arch", arch]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with jax_logits() as logits:
        want = _run(jserve.main)
    got = _run(tserve.main, [*argv, "--device", "cpu"])
    cfg = tget(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(4)]
    assert len(want.splitlines()) == 4
    _same_printout(got, want, logits, lambda: _eps(
        T.init_params(prng.PRNGKey(0), cfg, device="cpu"), cfg, prompts, 128), f"{arch} CLI")


def _example(path: Path):
    spec = importlib.util.spec_from_file_location(f"serve_lm_{path.parent.name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_printout_matches_jax(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    with jax_logits() as logits:
        want = _run(_example(ROOT / "examples" / "serve_lm.py").main)
    got = _run(_example(ROOT / "examples_torch" / "serve_lm.py").main, ["--device", "cpu"])
    cfg = tget("llama3.2-1b")
    prompts = [[1, 5, 9, 13], [2, 4, 8], [3, 3, 3, 3, 3], [7, 11]]
    assert want.splitlines()[-1] == "served 4 requests to completion"
    _same_printout(got, want, logits, lambda: _eps(
        T.init_params(prng.PRNGKey(0), cfg, device="cpu"), cfg, prompts, 128), "example")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device is usable")
    cfg = tget("llama3.2-1b")
    params = T.init_params(prng.PRNGKey(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--max-new", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(ROOT / "examples_torch" / "serve_lm.py").main([])
    out = Engine(cfg, params, device="cpu").generate([Request(prompt=[1, 2], max_new_tokens=3)])
    assert len(out[0].generated) == 3 and out[0].done
