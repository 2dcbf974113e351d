"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``).

Tolerances come from a float64 run, not from ulps: ``rounding_level``
runs the port's step once more with its params, batch and every float32
or bf16 op in float64 (``tools_torch/fp_rounding.py``'s
``float64_math``, which takes away attention's bf16 rounding of its
matmul inputs too) and measures how far float32 / bf16 rounding alone
moves the port's own result.  A fault of the port moves its float32 and
float64 results alike, so it does not widen that yardstick; it shows as a
distance from JAX's result far beyond it.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.parallel.tree import leaves, tree_map
from repro_torch.train import trainer as ttr

if str(Path(__file__).resolve().parents[1]) not in sys.path:
    sys.path.append(str(Path(__file__).resolve().parents[1]))
from tools_torch.fp_rounding import float64_math  # noqa: E402

#: a leaf's gradient may lie this many rounding levels from JAX's
GRAD_LEVELS = 3.0


def dev(got, want) -> float:
    """max |got − want| / max |want| over a tensor (0 for an all-zero pair)."""
    a = np.asarray(got.detach().double() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    b = np.asarray(want.detach().double() if isinstance(want, torch.Tensor) else want,
                   np.float64)
    scale = np.abs(b).max() if b.size else 0.0
    diff = np.abs(a - b).max() if a.size else 0.0
    return float(diff / scale) if scale > 0 else float(diff)


def make_batch(cfg, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    """A seeded numpy batch for ``cfg`` (tokens or stub embeddings, labels,
    encoder embeddings for the encoder-decoder archs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.embeds_input:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def variant(jcfg, tcfg, *, f32: bool = False, les: int = 0, int8: bool = False):
    """The JAX and port configs with float32 compute, LES groups (and at
    least 4 layers, as the launcher sets them) or the int8 MLP path."""
    import jax.numpy as jnp

    j, t = {}, {}
    if f32:
        j["dtype"], t["dtype"] = jnp.float32, torch.float32
    if les:
        for d in (j, t):
            d.update(les_groups=les, num_layers=max(jcfg.num_layers, 4))
    if int8:
        j["int8_matmul"] = t["int8_matmul"] = True
    return dataclasses.replace(jcfg, **j), dataclasses.replace(tcfg, **t)


def rounding_level(params, cfg, batch: dict, grads) -> float:
    """The largest distance, over the gradient's leaves, between the port's
    gradient and the same gradient with its float math in float64."""
    b64 = {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()}
    with float64_math():
        _, g64 = ttr.value_and_grad(tree_map(torch.Tensor.double, params),
                                    dataclasses.replace(cfg, dtype=torch.float64), b64)
    return max(dev(a, b) for a, b in zip(leaves(grads), leaves(g64)))


#: the AdamW steps each case runs (lr = 0 at step 0, so the first two
#: move the params)
STEPS = 3
#: two runs whose gradients differ by rounding may still move a coordinate
#: in opposite directions: AdamW's |m̂/√v̂| ≤ 1.001 for t ≤ 3 at β = (0.9,
#: 0.95) (Cauchy–Schwarz over the bias-corrected weights), so they part by
#: at most 2 · 1.001 · Σ lr, plus the decay term's rounding
ADAM_PART = 2.01


#: AdamW's moments after each step may lie this many rounding levels from
#: JAX's: mu is linear in the gradients (GRAD_LEVELS), nu quadratic (twice
#: that: |a² − b²| ≤ |a − b| · 2 max|b|, relative to max b²)
MU_LEVELS = GRAD_LEVELS
NU_LEVELS = 2 * GRAD_LEVELS
#: one AdamW update on identical inputs: the same float32 formulas element
#: by element, apart from the grad norm's summation order, which moves the
#: clip scale, and so mu, nu and the step, by a few float32 ulps
UPDATE_TOL = 2.0 ** -20


#: compiler options for JAX's reference step (see ``run_case``)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def run_case(arch: str, *, f32: bool = False, les: int = 0, int8: bool = False) -> dict:
    """One case of the LM training parity tests: from the port's
    ``init_state(PRNGKey(0))`` (≡ JAX's init within ``INIT_TOL``,
    ``test_torch_lm_models.py``) handed to both, JAX's loss, gradients and
    STEPS AdamW steps (one compile) and the port's on the same batch, and the
    port's rounding level ε (float64 run)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jget
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtr
    from repro_torch.configs import get_smoke_config as tget
    from repro_torch.core import prng

    jc, tc = variant(jget(arch), tget(arch), f32=f32, les=les, int8=int8)
    ts = ttr.init_state(prng.PRNGKey(0), tc, device="cpu")
    host = tree_map(lambda t: t.numpy(), ts[0])
    js = (jax.tree.map(jnp.asarray, host), jopt.init(host), jnp.zeros((), jnp.int32))
    b = make_batch(jc)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def jstep(state, batch):
        # JAX's train_step (repro/train/trainer.py) with its gradient returned
        params, adam, step = state
        (_, m), g = jax.value_and_grad(jtr.loss_fn, has_aux=True)(params, jc, batch)
        lr = jopt.lr_schedule(step, peak=jc.learning_rate, total=10_000)
        new_p, new_adam, gnorm = jopt.update(params, g, adam, lr=lr,
                                             weight_decay=jc.weight_decay)
        return (new_p, new_adam, step + 1), m, g, gnorm, lr

    # XLA's cheaper CPU pipeline: the same program, a third less compile
    # time; its float results lie within rounding of the default's
    jstep = jax.jit(jstep).lower(js, jb).compile(compiler_options=FAST_COMPILE)
    out = {"jax": [], "port": [], "jax_moments": [], "port_moments": []}
    s_j, s_t = js, ts
    for i in range(STEPS):
        s_j, jlm, jg, gnorm, lr = jstep(s_j, jb)
        if i == 0:
            out["jax_grads"] = [np.asarray(g) for g in jax.tree.leaves(jg)]
            out["jax_loss_metrics"] = {k: float(v) for k, v in jlm.items()}
        out["jax"].append({**{k: float(v) for k, v in jlm.items()},
                           "grad_norm": float(gnorm), "lr": float(lr)})
        out["jax_moments"].append([[np.asarray(a) for a in jax.tree.leaves(m)]
                                   for m in (s_j[1].mu, s_j[1].nu)])
    (_, tlm), tg = ttr.value_and_grad(ts[0], tc, tb)
    out["port_grads"] = leaves(tg)
    out["port_loss_metrics"] = {k: float(v) for k, v in tlm.items()}
    out["eps"] = rounding_level(ts[0], tc, tb, tg)
    for _ in range(STEPS):
        s_t, tm = ttr.train_step(s_t, tc, tb)
        out["port"].append({k: float(v) for k, v in tm.items()})
        out["port_moments"].append([leaves(m) for m in (s_t[1].mu, s_t[1].nu)])
    out["jax_state"] = jax.tree.map(np.asarray, s_j)
    out["port_state"] = s_t
    out["weight_decay"] = tc.weight_decay
    return out


def check_loss_and_grads(r: dict, what: str) -> None:
    """The loss metrics within ε of JAX's (relative), every gradient leaf
    within GRAD_LEVELS · ε."""
    eps = r["eps"]
    for k, v in r["jax_loss_metrics"].items():
        got = r["port_loss_metrics"][k]
        assert abs(got - v) <= eps * max(abs(v), 1.0), f"{what} {k}: {got} vs {v}, ε {eps:.2e}"
    assert len(r["port_grads"]) == len(r["jax_grads"])
    for i, (a, b) in enumerate(zip(r["port_grads"], r["jax_grads"])):
        assert tuple(a.shape) == b.shape
        d = dev(a, b)
        assert d <= GRAD_LEVELS * eps, f"{what} grad leaf {i}: {d:.3e} vs ε {eps:.3e}"


def check_steps(r: dict, what: str) -> None:
    """STEPS AdamW steps: each step's loss within ε and grad norm within
    GRAD_LEVELS · ε of JAX's, the lr schedule's values equal to float32
    rounding, AdamW's moments after each step within MU_LEVELS · ε (mu,
    linear in the gradients) and NU_LEVELS · ε (nu, quadratic) of JAX's,
    leaf by leaf, the step counters equal, and every parameter within
    ADAM_PART · Σ lr of JAX's."""
    eps = r["eps"]
    lrs = []
    for i, (jm, tm) in enumerate(zip(r["jax"], r["port"])):
        assert abs(tm["loss"] - jm["loss"]) <= eps * max(abs(jm["loss"]), 1.0), (what, i)
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= GRAD_LEVELS * eps * jm["grad_norm"]
        assert abs(tm["lr"] - jm["lr"]) <= 1e-7 * max(abs(jm["lr"]), 1e-30), (what, i)
        lrs.append(jm["lr"])
        for name, levels, got, want in zip(("mu", "nu"), (MU_LEVELS, NU_LEVELS),
                                           r["port_moments"][i], r["jax_moments"][i]):
            assert len(got) == len(want)
            for j, (a, b) in enumerate(zip(got, want)):
                d = dev(a, b)
                assert d <= levels * eps, \
                    f"{what} step {i} {name} leaf {j}: {d:.3e} vs ε {eps:.3e}"
    assert lrs[0] == 0.0
    jp, jadam, jstep = r["jax_state"]
    tp, tadam, tstep = r["port_state"]
    assert int(tstep) == int(jstep) == STEPS and int(tadam.count) == int(jadam.count)
    bound = ADAM_PART * sum(lrs)
    for i, (a, b) in enumerate(zip(leaves(tp), jax_leaves(jp))):
        d = float(np.abs(a.double().numpy() - b.astype(np.float64)).max())
        assert d <= bound, f"{what} param leaf {i}: {d:.3e} > {bound:.3e}"


@functools.cache
def _jax_update(weight_decay: float):
    """JAX's AdamW update at lr 1e-3, jitted once: a case's two gains share
    its compile."""
    import jax

    from repro.train import optimizer as jopt

    return jax.jit(functools.partial(jopt.update, lr=1e-3, weight_decay=weight_decay))


def check_update(r: dict, what: str, gain: float) -> None:
    """One AdamW update of both packages on the same inputs: JAX's state
    after STEPS steps (params, mu, nu, count), JAX's first gradient scaled
    to a global norm of ``gain`` (clipped when above 1), lr 1e-3.  The new
    params, mu and nu lie within UPDATE_TOL of JAX's, leaf by leaf, the
    grad norm within UPDATE_TOL (relative), the counts equal."""
    import jax
    import jax.numpy as jnp

    from repro_torch.parallel.tree import unflatten
    from repro_torch.train import optimizer as topt

    jp, jadam, _ = r["jax_state"]
    norm = float(np.sqrt(sum(np.square(g.astype(np.float64)).sum() for g in r["jax_grads"])))
    grads = [(g * np.float32(gain / norm)).astype(g.dtype) for g in r["jax_grads"]]
    jtree = jax.tree.structure(jp)
    jg = jax.tree.unflatten(jtree, [jnp.asarray(g) for g in grads])
    jnew, jstate, jnorm = _jax_update(r["weight_decay"])(
        jax.tree.map(jnp.asarray, jp), jg, jax.tree.map(jnp.asarray, jadam))
    tp = r["port_state"][0]

    def port_tree(arrays):
        return unflatten(tp, [torch.from_numpy(np.array(a)) for a in arrays])

    tstate = topt.AdamWState(mu=port_tree(jax.tree.leaves(jadam.mu)),
                             nu=port_tree(jax.tree.leaves(jadam.nu)),
                             count=torch.tensor(int(jadam.count), dtype=torch.int32))
    tnew, tstate, tnorm = topt.update(port_tree(jax.tree.leaves(jp)), port_tree(grads),
                                      tstate, lr=1e-3, weight_decay=r["weight_decay"])
    assert abs(float(tnorm) - float(jnorm)) <= UPDATE_TOL * float(jnorm), (what, gain)
    assert int(tstate.count) == int(jstate.count) == int(jadam.count) + 1
    for name, got, want in (("params", tnew, jnew), ("mu", tstate.mu, jstate.mu),
                            ("nu", tstate.nu, jstate.nu)):
        for j, (a, b) in enumerate(zip(leaves(got), jax.tree.leaves(want))):
            d = dev(a, np.asarray(b))
            assert d <= UPDATE_TOL, f"{what} gain {gain} {name} leaf {j}: {d:.3e}"


def jax_leaves(tree) -> list:
    import jax

    return jax.tree.leaves(tree)


def case_id(case) -> str:
    arch, kw = case
    return "-".join([arch, "f32" if kw.get("f32") else "own-dtype",
                     *(["les"] if kw.get("les") else []), *(["int8"] if kw.get("int8") else [])])


@pytest.fixture(scope="module")
def runs():
    """``run_case`` memoised for the module: a case's two tests share one
    JAX jit and one port run."""
    cache = {}

    def get(case):
        key = case_id(case)
        if key not in cache:
            cache[key] = run_case(case[0], **case[1])
        return cache[key]

    return get
