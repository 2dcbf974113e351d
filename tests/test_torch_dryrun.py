"""PyTorch port, the dry-run scaffolding ≡ the JAX package's, on the CPU:

  * ``launch/shapes.py`` and ``trainer.abstract_state``: every leaf's
    shape and dtype, for every arch's published config × every applicable
    shape, against JAX's ``eval_shape`` — traced on ``meta``, nothing
    allocated (a 72B config included);
  * ``launch/op_analysis.py``: the known program of JAX's
    ``test_hlo_analyzer_on_known_program``; a smoke train step traced on
    ``meta`` counts exactly what the same step on the CPU counts (ops,
    FLOPs by dtype, bytes, live-storage peak), the int8 path's products
    included; ``int_matmul`` on meta counts one int8 product; the smoke
    prefill's matmul FLOPs against JAX's HLO dot FLOPs, the gap being the
    Q/K/V projection the prefill computes twice (XLA's CSE merges it);
  * ``launch/dryrun.py``: a published cell's JSON through ``run_cell`` and
    the CLI, on H100 constants, and ``tools_torch/make_roofline_table.py``
    over the JSONs; the analytic collectives of a train step;
  * ``trainer.build_prefill`` / ``build_decode_step`` against JAX's on a
    one-chip mesh, within the serving tests' rounding levels;
  * ``parallel/pipeline.py``: the sequential path, the stage path on gloo
    at 2 and 3 ranks (``tests/_torch_pipeline_world.py``, one spawn each)
    against JAX's ``vmap`` test, ``bubble_fraction``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import dev
from _torch_lm_serve import SERVE_LEVELS, port_decode, port_prefill, serve_batch
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget
from repro.launch import shapes as jS
from repro.launch.hlo_analysis import analyze
from repro.launch.mesh import make_test_mesh as jtest_mesh
from repro.models import transformer as jT
from repro.parallel import pipeline as jpipe
from repro.parallel.sharding import serve_rules
from repro.train import trainer as jtr
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs import list_archs
from repro_torch.core import numerics, prng
from repro_torch.device import dry_run, resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_analysis as oa
from repro_torch.launch import shapes as tS
from repro_torch.models import transformer as T
from repro_torch.parallel import pipeline as tpipe
from repro_torch.parallel.tree import leaves, tree_map
from repro_torch.train import trainer as ttr
from tools_torch.make_roofline_table import rows, table

ROOT = Path(__file__).resolve().parents[1]
WORLD = Path(__file__).resolve().parent / "_torch_pipeline_world.py"


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """The gloo worlds of 2 and 3 ranks, started with the module's first
    test so they run while the others do."""
    out = tmp_path_factory.mktemp("pipeline")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = {n: subprocess.Popen([sys.executable, str(WORLD), "--ranks", str(n),
                                  "--out", str(out / f"p{n}.npy")], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in (2, 3)}
    yield procs, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------


def _same(port_tree, jax_tree, what: str) -> int:
    """Leaf for leaf the same shape and dtype; every port leaf on meta."""
    got, want = leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "meta", (what, i)
        assert tuple(g.shape) == tuple(w.shape), (what, i, tuple(g.shape), w.shape)
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, (what, i)
    return len(got)


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_inputs_equal_jax(arch):
    jc, tc = jget_config(arch), tget_config(arch)
    _same(ttr.abstract_state(prng.PRNGKey(0), tc), jtr.abstract_state(jax.random.PRNGKey(0), jc),
          f"{arch} state")
    for name in tS.SHAPES:
        jcell, tcell = jS.cell(jc, name), tS.cell(tc, name)
        assert dataclasses.asdict(tcell) == dataclasses.asdict(jcell)
        if not tcell.applicable:
            continue
        b, s = tcell.batch, tcell.seq
        if tcell.kind == "train":
            _same(tS.train_batch_specs(tc, b, s), jS.train_batch_specs(jc, b, s), name)
            continue
        if tcell.kind == "prefill":
            _same(tS.prefill_batch_specs(tc, b, s), jS.prefill_batch_specs(jc, b, s), name)
        _same(tS.abstract_cache(tc, b, s), jS.abstract_cache(jc, b, s), f"{name} cache")
        _same(tS.decode_token_specs(b), jS.decode_token_specs(b), name)
        enc = tS.enc_out_specs(tc, b)
        assert (enc is None) == (jS.enc_out_specs(jc, b) is None)
        if enc is not None:
            _same(enc, jS.enc_out_specs(jc, b), f"{name} enc_out")
    assert [c.shape for c in tS.all_cells(tc)] == [c.shape for c in jS.all_cells(jc)]


def test_meta_only_inside_the_dry_run():
    """No entry point that computes accepts ``meta``; the dry run does."""
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(ValueError):
        T.init_params(prng.PRNGKey(0), tget("llama3.2-1b"), device="meta")
    with dry_run():
        assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("meta")


# ---------------------------------------------------------------------------
# The op analyzer
# ---------------------------------------------------------------------------


def test_analyzer_on_known_program():
    """JAX's case: 4 loop trips of a 64³ float32 matmul and a tanh count
    4 · 2 · 64³ float32 FLOPs, in both packages."""
    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        out, _ = jax.lax.scan(body, x, ws)
        return out

    comp = jax.jit(f).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32),
                            jax.ShapeDtypeStruct((4, 64, 64), jnp.float32)).compile()
    want = analyze(comp.as_text()).flops["f32"]
    x = torch.empty((64, 64), device="meta")
    ws = torch.empty((4, 64, 64), device="meta")
    with oa.OpAnalyzer() as an:
        c = x
        for w in ws:
            c = torch.tanh(c @ w)
    assert an.costs.flops["f32"] == want == 4 * 2 * 64 ** 3
    assert an.costs.flops["elementwise"] == 4 * 64 * 64
    # 4 mm and 4 tanh read their operands and write their results; the loop's
    # unbind of ws is a view: an op that moves nothing
    assert an.costs.hbm_bytes == 4 * (3 + 2) * 64 * 64 * 4
    assert an.costs.ops == 9 and an.costs.by_op["unbind.int"] == 1


def _smoke_step(cfg, device: str):
    """A smoke train step of ``cfg`` on ``device`` under the analyzer."""
    b, s = 2, 16
    with dry_run():
        state = ttr.init_state(prng.PRNGKey(0), cfg, device=device)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}
    with oa.OpAnalyzer() as an:
        ttr.build_train_step(cfg)(state, batch)
    return an


@pytest.mark.parametrize("arch,int8", [("llama3.2-1b", False), ("llama3.2-1b", True),
                                       ("olmoe-1b-7b", False)],
                         ids=["llama", "llama-int8", "olmoe"])
def test_meta_trace_equals_cpu_trace(arch, int8):
    cfg = dataclasses.replace(tget(arch), int8_matmul=int8)
    cpu, meta = _smoke_step(cfg, "cpu"), _smoke_step(cfg, "meta")
    assert meta.costs.summary() == cpu.costs.summary()
    assert meta.costs.by_op == cpu.costs.by_op
    assert meta.costs.products == cpu.costs.products
    assert meta.peak("meta") == cpu.peak("cpu") > 0
    assert cpu.costs.transfers == 0 and meta.costs.transfers > 0  # host scalars to meta
    if int8:
        # the MLP's 3 products a layer (the smoke config has no remat)
        assert not cfg.remat and len(meta.costs.products) == 3 * cfg.num_layers
        assert {p[3] for p in meta.costs.products} == {"int8"}
        assert meta.costs.flops["int8"] == sum(2 * a[0] * a[1] * b[1]
                                               for _, a, b, _ in meta.costs.products)


def test_int_matmul_on_meta_counts_one_int8_product():
    a = torch.empty((8, 16), dtype=torch.int8, device="meta")
    w = torch.empty((16, 4), dtype=torch.int8, device="meta")
    with oa.OpAnalyzer() as an:
        z = numerics.int_matmul(a, w)
        numerics.int_matmul(a.to(torch.int32), w)
    assert z.device.type == "meta" and z.shape == (8, 4) and z.dtype == torch.int32
    c = an.costs
    assert c.products == [("int_matmul", (8, 16), (16, 4), "int8"),
                          ("int_matmul", (8, 16), (16, 4), "int32")]
    assert c.flops["int8"] == c.flops["int32"] == 2 * 8 * 16 * 4
    assert c.ops == 3  # the two products and the int32 cast
    assert numerics.int_matmul(a, w).shape == (8, 4)  # outside an analyzer too
    with oa.OpAnalyzer() as outer:  # nested analyzers: each counts the product once
        with oa.OpAnalyzer() as inner:
            numerics.int_matmul(a, w)
    for n in (outer, inner):
        assert n.costs.ops == 1 and n.costs.by_op == {"int_matmul": 1}
        assert n.costs.products == [("int_matmul", (8, 16), (16, 4), "int8")]


def test_moe_shard_refused(monkeypatch, capsys):
    """JAX's ``--moe-shard`` pins MoE dispatch buffers with a sharding
    constraint; eager torch places nothing, so the port's CLI refuses the
    flag instead of writing an override that changes no trace."""
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "olmoe-1b-7b", "--shape",
                                      "train_4k", "--moe-shard"])
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 2 and "places no MoE dispatch buffers" in capsys.readouterr().err


def _dup_qkv_flops(cfg, b: int, s: int) -> int:
    """The FLOPs of the prefill's second Q/K/V projection: one per
    attention layer (``models/lm.py`` ``_fill_kv_cache``)."""
    kinds = list(cfg.scan_unit) * cfg.scan_repeats + list(cfg.tail)
    n_attn = sum(k in ("attn", "local_attn", "attn_cross") for k in kinds)
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    return 2 * b * s * cfg.d_model * qkv * n_attn


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b", "h2o-danube-1.8b"])
def test_prefill_flops_against_jax_hlo(arch):
    """The smoke prefill at B = 2, S = 64: the port's matmul FLOPs (meta
    trace) minus JAX's HLO dot FLOPs is exactly the duplicate Q/K/V
    projection, which XLA's CSE merges and eager torch computes twice."""
    b, s = 2, 64
    jc, tc = jget(arch), tget(arch)
    mesh = jtest_mesh()
    rules = jtr.resolved_rules(jc, serve_rules())
    specs = jS.prefill_batch_specs(jc, b, s)
    params = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, jnp.bfloat16 if x.dtype == jnp.float32
                                       else x.dtype),
        jax.eval_shape(lambda: jT.init_params(jax.random.PRNGKey(0), jc)))
    with mesh:
        fn = jtr.build_prefill(jc, mesh, rules, shapes={k: v.shape for k, v in specs.items()})
        hlo = analyze(fn.lower(params, specs, jS.abstract_cache(jc, b, s)).compile().as_text())
    jax_dots = sum(v for k, v in hlo.flops.items() if k != "elementwise")
    trace = dryrun.trace_step(tc, "prefill", b, s, tmesh.make_test_mesh(),
                              dryrun.make_rules(tc, mode="serve", multi_pod=False, batch=b))
    port_mm = sum(v for k, v in trace.costs.flops.items() if k != "elementwise")
    assert port_mm - jax_dots == _dup_qkv_flops(tc, b, s) > 0


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def test_run_cell_and_cli_on_h100_constants(tmp_path):
    """A published cell (llama3.2-1b decode_32k on the 256-chip mesh) through
    ``run_cell``: per-chip memory, FLOPs by dtype, bytes, analytic
    collectives and roofline terms from the H100's constants; a cell that
    does not apply through the CLI."""
    out = tmp_path / "llama3.2-1b_decode_32k_pod1.json"
    r = dryrun.run_cell("llama3.2-1b", "decode_32k", multi_pod=False, out=str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(r, default=str))
    cfg = tget_config("llama3.2-1b")
    assert r["chips"] == 256 and r["kind"] == "decode" and not r["skipped"]
    mem, roof = r["memory"], r["roofline"]
    assert mem["hbm_gib"] == oa.HBM_PER_CHIP / 2 ** 30 and mem["fits_hbm"]
    assert 0 < mem["inputs_gib"] < mem["live_gib"]
    assert roof["collectives"] == "analytic"
    # serving: two all-reduces a layer of the local activation (128 / 16
    # rows, one token, d_model bf16), at 2× wire, across the two nodes
    # the 16-chip model axis spans
    per = 2 * (128 // 16) * cfg.d_model * 2
    assert roof["collective_counts"] == {"all-reduce": 2 * cfg.num_layers}
    assert roof["collective_link_bytes"] == {"inter-node": 2 * cfg.num_layers * per}
    assert roof["collective_s"] == pytest.approx(2 * cfg.num_layers * per / oa.INTER_NODE_BW)
    assert roof["memory_s"] == pytest.approx(roof["hbm_bytes"] / 256 / oa.HBM_BW)
    assert roof["model_flops"] == 2 * cfg.active_param_count() * 128
    assert set(roof["flops_by_dtype"]) >= {"bf16", "f32", "elementwise"}
    assert roof["roofline_bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                           roof["collective_s"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    skip = tmp_path / "llama3.2-1b_long_500k_pod1.json"
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                    "llama3.2-1b", "--shape", "long_500k", "--out", str(skip)],
                   env=env, check=True, capture_output=True, timeout=120)
    assert json.loads(skip.read_text())["skipped"] is True
    lines = table(rows(str(tmp_path), "pod1")).splitlines()
    assert len(lines) == 4 and "| decode_32k |" in lines[2] and "SKIP" in lines[3]
    assert lines[2].endswith(f"{mem['live_gib']:.1f} of {mem['hbm_gib']:.1f} | ✓ |")


def test_train_collectives_from_the_placements():
    """A smoke train step on a (2, 2) mesh: each parameter leaf sharded
    over ``data`` all-gathered and its gradient reduce-scattered, the
    others' gradients all-reduced; four all-reduces a layer of the local
    activation over ``model``; the state's per-chip bytes from the
    placements."""
    cfg = tget("llama3.2-1b")
    mesh = tmesh.make_test_mesh(2, 2)
    rules = dryrun.make_rules(cfg, mode="train", multi_pod=False, batch=4)
    trace = dryrun.trace_step(cfg, "train", 4, 16, mesh, rules)
    shard = ttr.param_shardings(cfg, mesh, rules)
    n_fsdp = sum("data" in s.spec for s in dryrun._shardings(shard))
    n_rest = len(dryrun._shardings(shard)) - n_fsdp
    counts = dict(trace.costs.collective_counts)
    assert counts == {"all-gather": n_fsdp, "reduce-scatter": n_fsdp,
                      "all-reduce": n_rest + 4 * cfg.num_layers}
    state = ttr.abstract_state(prng.PRNGKey(0), cfg)
    assert sum(t.numel() * t.element_size() for t, _ in trace.inputs) == \
        sum(t.numel() * t.element_size() for t in leaves(state)) + 2 * 4 * 16 * 4
    assert sum(dryrun._local_bytes(t, s) for t, s in trace.inputs) == trace.input_bytes()
    assert trace.input_bytes() < sum(t.numel() * t.element_size() for t, _ in trace.inputs)
    assert trace.peak_bytes() > trace.input_bytes()


def test_peak_scales_storages_by_identity_not_shape():
    """A smoke train step on a (2, 2) mesh at batch × seq = d_model, so
    that activations and temporaries take parameters' shapes: only the
    gradients' and the new state's storages get their placements' share
    (each adding up to the placements' local bytes exactly); every other
    storage, those of a parameter's shape included, is divided by the
    batch and sequence shards."""
    cfg = tget("llama3.2-1b")
    mesh = tmesh.make_test_mesh(2, 2)
    b, s = 4, cfg.d_model // 4
    rules = dryrun.make_rules(cfg, mode="train", multi_pod=False, batch=b)
    trace = dryrun.trace_step(cfg, "train", b, s, mesh, rules)
    an, act = trace.analyzer, trace.act_scale
    grads = an.gradients
    assert len(grads) == len(trace.params) and None not in grads
    assert sum(an.size(sid) * trace.scales[sid] for sid in grads) == \
        sum(dryrun._local_bytes(t, sh) for t, sh in trace.params)
    n_batch = len(tS.train_batch_specs(cfg, b, s))
    state_local = sum(dryrun._local_bytes(t, sh) for t, sh in trace.inputs[:-n_batch])
    outs = [sid for sid in trace.scales if sid not in grads]
    assert sum(an.size(sid) * trace.scales[sid] for sid in outs) == state_local
    ratio = {tuple(t.shape): dryrun._local_bytes(t, sh) / (t.numel() * t.element_size())
             for t, sh in trace.params}
    lookalikes = [sid for sid, shape in enumerate(an.shapes)
                  if sid not in trace.scales and ratio.get(shape, act) != act]
    assert lookalikes  # the case a rule keyed on shapes would get wrong
    want = trace.input_bytes() + an.peak(
        scale=lambda sid: trace.scales[sid] if sid in trace.scales else act)
    assert trace.peak_bytes() == want


# ---------------------------------------------------------------------------
# The serving steps (build_prefill / build_decode_step)
# ---------------------------------------------------------------------------


def test_serving_steps_equal_jax():
    """``build_prefill`` / ``build_decode_step`` on a one-chip mesh against
    JAX's jitted ``build_*`` steps: logits within SERVE_LEVELS · ε (the port's
    float64 run), the decode from JAX's prefilled cache; their placements'
    specs those of JAX's trees."""
    arch, max_seq = "llama3.2-1b", 32
    jc, tc = jget(arch), tget(arch)
    tp = T.init_params(prng.PRNGKey(0), tc, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tp))
    batch = serve_batch(tc, s=12)
    shapes = {k: v.shape for k, v in batch.items()}
    rules = jtr.resolved_rules(jc, serve_rules())
    jm = jtest_mesh()
    with jm:
        jl, jcache = jtr.build_prefill(jc, jm, rules, shapes=shapes)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jT.init_cache(jc, 2, max_seq))
        carried = jax.tree.map(np.asarray, jcache)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jd, _ = jtr.build_decode_step(jc, jm, rules)(jp, tok, jcache)
    tm = tmesh.make_test_mesh()
    pre = ttr.build_prefill(tc, tm, rules, shapes=shapes)
    with torch.no_grad():
        pl, _ = pre(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    T.init_cache(tc, 2, max_seq, device="cpu"))
    l32, c32 = port_prefill(tp, tc, batch, max_seq)
    l64, _ = port_prefill(tp, tc, batch, max_seq, f64=True)
    assert torch.equal(pl, l32)
    eps = max(dev(l32, l64), 1e-7)
    assert dev(pl, np.asarray(jl)) <= SERVE_LEVELS * eps
    dec = ttr.build_decode_step(tc, tm, rules)
    with torch.no_grad():
        dl, _ = dec(tp, torch.tensor(np.asarray(tok)), T.cache_from_numpy(carried, "cpu"))
    d32, _ = port_decode(tp, tc, T.cache_from_numpy(carried, "cpu"), [np.asarray(tok)])
    d64, _ = port_decode(tp, tc, T.cache_from_numpy(carried, "cpu"), [np.asarray(tok)], f64=True)
    assert torch.equal(dl, d32[0])
    eps = max(dev(d32[0], d64[0]), 1e-7)
    assert dev(dl, np.asarray(jd)) <= SERVE_LEVELS * eps
    assert pre.in_shardings[1]["tokens"].spec == ("data", None)
    assert dec.in_shardings[1].spec == ("data",)
    assert dec.out_shardings[0].spec == pre.out_shardings[0].spec == ("data", "model")


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def test_split_microbatches_and_sequential_schedule_equal_jax():
    x = np.arange(24, dtype=np.int32).reshape(12, 2)
    got = tpipe.split_microbatches(torch.from_numpy(x), 3)
    assert got.shape == (3, 4, 2)
    assert np.array_equal(got.numpy(), np.asarray(jpipe.split_microbatches(jnp.asarray(x), 3)))
    with pytest.raises(ValueError):
        tpipe.split_microbatches(torch.from_numpy(x), 5)
    for stages, micro in ((3, 3), (1, 4), (4, 2)):
        got = tpipe.pipeline_apply(lambda s, m: m * 2 + s, torch.from_numpy(x),
                                   num_stages=stages, num_micro=micro)
        want = jpipe.pipeline_apply(lambda s, m: m * 2 + s, jnp.asarray(x),
                                    num_stages=stages, num_micro=micro)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [2, 3])
def test_stage_schedule_equals_jax_vmap(worlds, n):
    """Every rank of the gloo world holds what the same rank of JAX's
    ``vmap`` over the stage axis holds; the last rank, the sequential
    schedule's output."""
    procs, out = worlds
    log, _ = procs[n].communicate(timeout=300)
    assert procs[n].returncode == 0, log
    got = np.load(out / f"p{n}.npy")
    x = jnp.arange(6 * n, dtype=jnp.int32).reshape(3 * n, 2)
    want = jax.vmap(lambda v: jpipe.pipeline_apply(lambda s, m: m * 2, v, num_stages=n,
                                                   num_micro=3, axis_name="r"),
                    axis_name="r")(jnp.broadcast_to(x, (n, *x.shape)))
    assert got.shape == want.shape and np.array_equal(got, np.asarray(want))
    ref = jpipe.pipeline_apply(lambda s, m: m * 2, x, num_stages=n, num_micro=3)
    assert np.array_equal(got[n - 1], np.asarray(ref))


def test_bubble_fraction():
    for s, m in ((1, 8), (4, 8), (2, 4), (8, 1)):
        assert tpipe.bubble_fraction(s, m) == jpipe.bubble_fraction(s, m)
    assert tpipe.bubble_fraction(4, 8) == pytest.approx(3 / 11)
