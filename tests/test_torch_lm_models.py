"""PyTorch port, the LM model components (``repro_torch.models``) ≡ the JAX
package's (``repro.models``) on the same seeded numpy inputs, on the CPU.

Every float comparison takes its tolerance from a float64 run of the port
(``tests/_torch_lm.py``): the port's result with its inputs, params and
float math in float64
says how far rounding alone moves it (ε, the largest such distance over
the compared tensors); the port's float32 result may lie at most
``LEVELS`` · ε + ``FLOOR`` from JAX's, relative to the largest magnitude
of the tensor.  ``FLOOR`` (1e-6) covers the float32 rounding of a handful
of values where ε itself is at that level.  Integer results (top-k
indices, the int8 quantisation and product) are bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import dev, float64_math
from repro.configs import get_smoke_config as jget
from repro.models import attention as jatt
from repro.models import common as jcom
from repro.models import mlp as jmlp
from repro.models import rglru as jrg
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcom
from repro_torch.models import mlp as tmlp
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv as trwkv
from repro_torch.train.trainer import tree_from_numpy

LEVELS = 3.0
FLOOR = 1e-6


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def check(got32: list, got64: list, want: list, what: str) -> None:
    """Each port float32 tensor within LEVELS·ε + FLOOR of JAX's, ε the
    largest float32-vs-float64 distance of the port over the tensors."""
    eps = max(dev(a, b) for a, b in zip(got32, got64))
    for i, (a, w) in enumerate(zip(got32, want)):
        d = dev(a, np.asarray(w))
        assert d <= LEVELS * eps + FLOOR, f"{what}[{i}]: {d:.3e} from JAX, ε {eps:.3e}"


def _f32(cfg_j, cfg_t):
    return (dataclasses.replace(cfg_j, dtype=jnp.float32),
            dataclasses.replace(cfg_t, dtype=torch.float32))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN = {  # name → flash_attention kwargs
    "masked": dict(causal=True),
    "triangle": dict(causal=True, causal_mode="triangle"),
    "window": dict(causal=True, window=6),
    "non-causal": dict(causal=False),
    "uneven blocks": dict(causal=True, window=9, q_block=4, kv_block=8),
}


@pytest.mark.parametrize("mode,compute", [("masked", "f32"), *((m, "bf16") for m in ATTN)])
def test_flash_attention_and_its_backward(mode, compute):
    """Forward and the FlashAttention-2 backward (dq, dk, dv for a random
    cotangent), blockwise (blocks of 4 over S = 16)."""
    rng = np.random.default_rng(1)
    q, ct = (rng.standard_normal((2, 2, 2, 16, 8)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 2, 16, 8)).astype(np.float32) for _ in range(2))
    kw = {"q_block": 4, "kv_block": 4, "compute_dtype": compute, **ATTN[mode]}
    out, vjp = jax.vjp(jax.jit(lambda a, b, c: jatt.flash_attention(a, b, c, **kw)), q, k, v)
    want = [out, *vjp(jnp.asarray(ct))]

    def port(dtype):
        ts = [_t(a, dtype).requires_grad_(True) for a in (q, k, v)]
        o = tatt.flash_attention(*ts, **kw)
        return [o.detach(), *torch.autograd.grad(o, ts, _t(ct, dtype))]

    got = port(torch.float32)
    with float64_math():
        got64 = port(torch.float64)
    check(got, got64, want, f"flash {mode} {compute}")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def test_top_k_breaks_ties_to_the_lowest_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tmlp.top_k(_t(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch,skew", [("olmoe-1b-7b", False), ("olmoe-1b-7b", True),
                                       ("mixtral-8x22b", True)],
                         ids=["olmoe-spread", "olmoe-drops", "mixtral-drops"])
def test_moe_mlp(arch, skew):
    """Routing, capacity slotting, the trash row and its drops, the combine
    and the load-balance aux loss; with ``skew`` the router sends most
    tokens to expert 0, past its capacity."""
    jc, tc = _f32(jget(arch), tget(arch))
    params = jmlp.init_mlp(jax.random.PRNGKey(3), jc)
    if skew:
        params = dict(params, router=params["router"].at[:, 0].add(3.0))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, jc.d_model)).astype(np.float32)
    (out, aux), vjp = jax.vjp(jax.jit(lambda p, a: jmlp.moe_mlp(p, jc, a)), params,
                              jnp.asarray(x))
    gp, gx = vjp((jnp.ones_like(out), jnp.ones((), jnp.float32)))
    want = [out, aux, gx, *jax.tree.leaves(gp)]
    n = 16
    assert tmlp.moe_capacity(tc, n) == int(1.25 * n * jc.moe.top_k / jc.moe.num_experts) + 1

    def port(dtype):
        p = {k: v.to(dtype).requires_grad_(True) for k, v in tree_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu").items()}
        xt = _t(x, dtype).requires_grad_(True)
        o, a = tmlp.moe_mlp(p, dataclasses.replace(tc, dtype=dtype), xt)
        grads = torch.autograd.grad((o.sum() + a), [xt, *(p[k] for k in sorted(p))])
        return [o.detach(), a.detach(), *grads]

    got = port(torch.float32)
    with float64_math():
        got64 = port(torch.float64)
    check(got, got64, want, f"moe {arch}")


# ---------------------------------------------------------------------------
# RWKV6, RG-LRU
# ---------------------------------------------------------------------------


def test_rwkv_layer_chunked_scan():
    """rwkv_layer (time mix over two 64-token chunks, channel mix) and its
    gradient to the layer's input and parameters."""
    jc, tc = _f32(jget("rwkv6-3b"), tget("rwkv6-3b"))
    params = jrwkv.init_rwkv_layer(jax.random.PRNGKey(4), jc)
    params = dict(params, u=params["u"] + 0.3)  # a nonzero current-token bonus
    x = np.random.default_rng(3).standard_normal((2, 128, jc.d_model)).astype(np.float32)

    def jf(p, a):
        return jrwkv.rwkv_layer(p, jc, a, jrwkv.init_rwkv_state(jc, 2))[0]

    out, vjp = jax.vjp(jax.jit(jf), params, jnp.asarray(x))
    gp, gx = vjp(jnp.ones_like(out))
    want = [out, gx, *jax.tree.leaves(gp)]

    def port(dtype):
        p = {k: v.to(dtype).requires_grad_(True) for k, v in tree_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu").items()}
        xt = _t(x, dtype).requires_grad_(True)
        o, _ = trwkv.rwkv_layer(p, dataclasses.replace(tc, dtype=dtype), xt,
                                trwkv.init_rwkv_state(tc, 2))
        return [o.detach(), *torch.autograd.grad(o.sum(), [xt, *(p[k] for k in sorted(p))])]

    got = port(torch.float32)
    with float64_math():
        got64 = port(torch.float64)
    check(got, got64, want, "rwkv_layer")


def test_rglru_scan_and_block():
    """RG-LRU: the log-depth scan against ``lax.associative_scan`` (a
    nonzero incoming state), and the whole Griffin block with its causal
    conv, with gradients."""
    jc, tc = _f32(jget("recurrentgemma-9b"), tget("recurrentgemma-9b"))
    params = jrg.init_rglru_layer(jax.random.PRNGKey(5), jc)
    rng = np.random.default_rng(4)
    w = jc.lru_width or jc.d_model
    x = rng.standard_normal((2, 24, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    xb = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
    tail = rng.standard_normal((2, 3, w)).astype(np.float32)
    hj, lastj = jax.jit(jrg.rglru_scan)(params, jnp.asarray(x), jnp.asarray(h0))

    def jblock(p, a):
        return jrg.rglru_block(p, jc, a, jrg.RglruState(h=jnp.asarray(h0),
                                                        conv=jnp.asarray(tail)))[0]

    out, vjp = jax.vjp(jax.jit(jblock), params, jnp.asarray(xb))
    gp, gx = vjp(jnp.ones_like(out))
    want = [hj, lastj, out, gx, *jax.tree.leaves(gp)]

    def port(dtype):
        p = {k: v.to(dtype).requires_grad_(True) for k, v in tree_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu").items()}
        h, last = trg.rglru_scan(p, _t(x, dtype), _t(h0, dtype))
        xt = _t(xb, dtype).requires_grad_(True)
        o, _ = trg.rglru_block(p, dataclasses.replace(tc, dtype=dtype), xt,
                               trg.RglruState(h=_t(h0, dtype), conv=_t(tail, dtype)))
        grads = torch.autograd.grad(o.sum(), [xt, *(p[k] for k in sorted(p))])
        return [h.detach(), last.detach(), o.detach(), *grads]

    got = port(torch.float32)
    with float64_math():
        got64 = port(torch.float64)
    check(got, got64, want, "rglru")


# ---------------------------------------------------------------------------
# RoPE, M-RoPE, norms, the int8 path
# ---------------------------------------------------------------------------


def test_rope_and_mrope():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32)[None], (2, 12)).copy()
    pos3 = rng.integers(0, 40, (3, 2, 12)).astype(np.int32)
    want = [jcom.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
            jcom.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1_000_000.0, (2, 3, 3)),
            jcom.rms_norm(jnp.asarray(x), jnp.full((16,), 0.5, jnp.float32))]

    def port(dtype):
        xt = _t(x, dtype)
        return [tcom.apply_rope(xt, _t(pos), 10_000.0),
                tcom.apply_mrope(xt, _t(pos3), 1_000_000.0, (2, 3, 3)),
                tcom.rms_norm(xt, torch.full((16,), 0.5))]

    got = port(torch.float32)
    with float64_math():
        got64 = port(torch.float64)
    check(got, got64, want, "rope / mrope / rms_norm")


def test_int8_matmul_is_exact_with_zero_gradient():
    """quantize_weight_int8 and the int8 product (int_matmul) bitwise JAX's;
    the gradient through the int8 path is zero to x and w, as JAX's."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 24)) * 0.1).astype(np.float32)
    jq, js = jcom.quantize_weight_int8(jnp.asarray(w))
    tq, ts = tcom.quantize_weight_int8(_t(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    want, vjp = jax.vjp(lambda a, b: jcom.matmul(a, b, int8=True), jnp.asarray(x),
                        jnp.asarray(w))
    jgx, jgw = vjp(jnp.ones_like(want))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    got = tcom.matmul(xt, wt, int8=True)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    gx, gw = torch.autograd.grad(got.sum(), [xt, wt])
    assert not np.asarray(jgx).any() and not np.asarray(jgw).any()
    assert not gx.any() and not gw.any()
