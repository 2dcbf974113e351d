"""PyTorch port, LM serving at the model level (``models/lm.py``
``prefill`` / ``decode_step``, the caches of ``models/transformer.py``,
``attention.decode_attention``, the decode forms of the RG-LRU and RWKV
layers) ≡ the JAX package's, on the CPU, at every arch's smoke config.

Each case hands the port's ``init_params(PRNGKey(0))`` to both packages
and prefills 2 × 12 tokens into caches of 32 positions.  The port's
prefill logits and every cache leaf lie within SERVE_LEVELS · ε of JAX's,
with the same shape and dtype, and ``t`` equal.  Then JAX's prefilled
cache is carried in (``cache_from_numpy``) and 6 ``decode_step``s (12 for
h2o-danube, whose window of 16 the ring wraps), teacher-forced with JAX's
greedy tokens, give logits at each step and a final cache within
SERVE_LEVELS · ε.  ε is the port's rounding level: the same run with its
float math in float64 (``tests/_torch_lm_serve.py``).  The cases cover the
ring (h2o-danube, mixtral), MoE (olmoe, mixtral), the RWKV6 and RG-LRU
states, whisper's cross-attention on ``enc_out``, qwen2-vl's M-RoPE and
llama's int8 MLP path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import FAST_COMPILE, dev, variant
from _torch_lm_serve import (SERVE_LEVELS, check_cache, port_decode, port_prefill,
                             rounding_level, serve_batch)
from repro.configs import get_smoke_config as jget
from repro.models import lm as jlm
from repro.models import transformer as jT
from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs import list_archs
from repro_torch.core import prng
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as T
from repro_torch.models.attention import decode_attention
from repro_torch.parallel.tree import tree_map

MAX_SEQ = 32
PROMPT = 12
#: decode steps per case: h2o-danube's 12 wrap its ring of 16 at t = 16
STEPS = {"h2o-danube-1.8b": 12}
CASES = [(arch, False) for arch in list_archs()] + [("llama3.2-1b", True)]


def _case_id(case) -> str:
    return case[0] + ("-int8" if case[1] else "")


def run_case(arch: str, int8: bool) -> dict:
    """JAX's prefill and teacher-forced decode (one compile each), the
    port's prefill, the port's decode from JAX's prefilled cache, and the
    port's float64 runs of both."""
    jc, tc = variant(jget(arch), tget(arch), int8=int8)
    tp = T.init_params(prng.PRNGKey(0), tc, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tp))
    batch = serve_batch(tc, s=PROMPT)
    b = batch["tokens"].shape[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    enc = jb.get("enc_embeds")

    def jprefill(p, bt):
        return jlm.prefill(p, jc, bt, jT.init_cache(jc, b, MAX_SEQ))

    def jdecode(p, tok, cache, e):
        enc_out = jlm.run_encoder(p, jc, e) if e is not None else None
        return jlm.decode_step(p, jc, tok, cache, enc_out=enc_out)

    jpre = jax.jit(jprefill).lower(jp, jb).compile(compiler_options=FAST_COMPILE)
    jl, jcache = jpre(jp, jb)
    out = {"jax_prefill": np.asarray(jl), "jax_prefill_cache": jax.tree.map(np.asarray, jcache)}
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    jdec = jax.jit(jdecode).lower(jp, tok, jcache, enc).compile(compiler_options=FAST_COMPILE)
    toks, jlogits = [], []
    for _ in range(STEPS.get(arch, 6)):
        toks.append(np.asarray(tok))
        jl, jcache = jdec(jp, tok, jcache, enc)
        jlogits.append(np.asarray(jl))
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    out.update(jax_decode=jlogits, jax_cache=[np.asarray(x) for x in jax.tree.leaves(jcache)],
               tokens=toks)

    pl, pc = port_prefill(tp, tc, batch, MAX_SEQ)
    pl64, pc64 = port_prefill(tp, tc, batch, MAX_SEQ, f64=True)
    out.update(port_prefill=pl, port_prefill_cache=pc, eps_prefill=rounding_level(
        [pl], pc, [pl64], pc64))

    def carried():
        return T.cache_from_numpy(out["jax_prefill_cache"], device="cpu")

    dl, dc = port_decode(tp, tc, carried(), toks, batch.get("enc_embeds"))
    dl64, dc64 = port_decode(tp, tc, carried(), toks, batch.get("enc_embeds"), f64=True)
    out.update(port_decode=dl, port_cache=dc, eps_decode=rounding_level(dl, dc, dl64, dc64))
    return out


@pytest.fixture(scope="module")
def runs():
    return functools.cache(run_case)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_matches_jax(runs, case):
    r = runs(*case)
    eps, what = r["eps_prefill"], f"{_case_id(case)} prefill"
    d = dev(r["port_prefill"], r["jax_prefill"])
    assert r["port_prefill"].dtype == torch.float32
    assert d <= SERVE_LEVELS * eps, f"{what} logits: {d:.3e} vs ε {eps:.3e}"
    jax_leaves = jax.tree.leaves(r["jax_prefill_cache"])
    check_cache(r["port_prefill_cache"], jax_leaves, SERVE_LEVELS * eps, what)
    assert int(r["port_prefill_cache"]["t"]) == int(r["jax_prefill_cache"]["t"]) == PROMPT


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_decode_matches_jax(runs, case):
    r = runs(*case)
    eps, what = r["eps_decode"], f"{_case_id(case)} decode"
    assert len(r["port_decode"]) == len(r["jax_decode"]) == STEPS.get(case[0], 6)
    for i, (a, b) in enumerate(zip(r["port_decode"], r["jax_decode"])):
        d = dev(a, b)
        assert d <= SERVE_LEVELS * eps, f"{what} step {i}: {d:.3e} vs ε {eps:.3e}"
    check_cache(r["port_cache"], r["jax_cache"], SERVE_LEVELS * eps, what)
    assert int(r["port_cache"]["t"]) == PROMPT + len(r["tokens"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "h2o-danube-1.8b"])
def test_decode_continues_prefill(arch):
    """logits(decode step s | prefill[0:s]) ≡ logits(full forward)[s], in
    float32 with the JAX package's own tolerances for this check
    (``tests/test_models_correctness.py``); h2o-danube's ring of 16 wraps
    at the decode step."""
    import dataclasses

    cfg = dataclasses.replace(tget(arch), dtype=torch.float32)
    params = T.init_params(prng.PRNGKey(0), cfg, device="cpu")
    b, s = 2, 16
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    with torch.no_grad():
        x = tlm._embed(params, cfg, tokens)
        h, _, _ = tlm.run_stack(params, cfg, x, tlm._positions(cfg, b, s + 1, "cpu"))
        h = T.rms_norm(h, params["final_ln"])
        want_prefill = tlm._logits(params, cfg, h[:, s - 1, :])
        want_decode = tlm._logits(params, cfg, h[:, s, :])
        cache = T.init_cache(cfg, batch=b, max_seq=32, device="cpu")
        got_prefill, cache = tlm.prefill(params, cfg, {"tokens": tokens[:, :s]}, cache)
        got_decode, cache = tlm.decode_step(params, cfg, tokens[:, s], cache)
    np.testing.assert_allclose(got_prefill.numpy(), want_prefill.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_decode.numpy(), want_decode.numpy(), rtol=2e-2, atol=2e-2)
    assert int(cache["t"]) == s + 1


def _plain(tree):
    """A cache-axes tree with its NamedTuples as (class name, fields)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return (type(tree).__name__, {f: getattr(tree, f) for f in tree._fields})
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


@pytest.mark.parametrize("arch", list_archs())
def test_cache_logical_axes_match_jax(arch):
    assert _plain(T.cache_logical_axes(tget(arch))) == _plain(jT.cache_logical_axes(jget(arch)))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("t", [3, 7, 20])
def test_decode_attention_matches_jax(window, t):
    """The ring mask (a floor mod of negative differences) and the bf16
    rounding of q, k, the weights and v: the same float32 result as JAX's
    within float32 summation order."""
    from repro.models.attention import decode_attention as jdecode_attention

    rng = np.random.default_rng(t)
    q = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.tensor(t, dtype=torch.int32), window=window)
    want = jdecode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(t, jnp.int32), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
