"""PyTorch port, data parallelism ≡ the JAX package, bitwise, on the CPU.

  * in-process: the int8-limb wire format (``pack_int8_limbs``,
    ``unpack_limb_sums``, ``fits_limbs``) on full-range int32 with
    INT32_MIN/MAX planted, the EF ``compress``/``decompress``, the rule
    tables and ``resolve``, and the tree walk ≡ JAX's; the one-rank paths
    and the rejections;
  * one gloo world of 2 and one of 4 ranks on the CPU
    (``tests/_torch_dp_world.py``, through ``parallel.dp.spawn``), started
    while the JAX references compile: every rank's trajectory for every
    reducer (the tiny net with dropout on both blocks, 3 steps; VGG8B at
    scale 0.0625, 2 steps), ``fuse_opt`` at 2 ranks and telemetry at 4 ≡
    JAX's **single-device** ``les.train_step`` (``backend="reference"``),
    leaf for leaf, dtype included — the cells of
    ``tests/test_data_parallel.py::TestDeviceCounts``; the ring's chunk
    ownership and rank order, int32 wrap through every reducer, the EF
    all-reduce ≡ JAX's under ``vmap``, and a two-rank resume from
    ``--ckpt-dir`` ≡ one device under the launcher's resume semantics.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import les as jles
from repro.core.blocks import BlockSpec as JBlockSpec
from repro.core.model import NitroConfig as JNitroConfig
from repro.parallel import compress as jcompress
from repro.parallel import dp as jdp
from repro.parallel import sharding as jsharding
from repro_torch.core import les as tles
from repro_torch.core import prng
from repro_torch.core.blocks import BlockSpec as TBlockSpec
from repro_torch.core.model import NitroConfig as TNitroConfig
from repro_torch.parallel import collectives, compress, dp, sharding, tree

WORLD = Path(__file__).resolve().parent / "_torch_dp_world.py"
ROOT = Path(__file__).resolve().parents[1]
INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max
REDUCERS = dp.REDUCERS


def _eq(got, want, what="") -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), what


def _full_range(shape, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.integers(INT32_MIN, INT32_MAX, shape, dtype=np.int64, endpoint=True)
    flat = v.reshape(-1)
    flat[:6] = [INT32_MIN, INT32_MAX, 0, -1, INT32_MIN + 1, INT32_MAX - 1]
    return v.astype(np.int32)


# ---------------------------------------------------------------------------
# In-process: the wire format, EF path, rules, tree walk
# ---------------------------------------------------------------------------


def test_parallel_package_matches_jax_names():
    assert dp.REDUCERS == jdp.REDUCERS and dp.DP_AXIS == jdp.DP_AXIS
    for name in ("exact_integer_psum", "pack_int8_limbs", "unpack_limb_sums", "fits_limbs",
                 "nitro_compressed_psum", "EFState", "ef_init", "compress", "decompress",
                 "compressed_psum"):
        assert hasattr(compress, name) and hasattr(jcompress, name), name
    for name in ("data_mesh", "reduce_gradients", "dp_train_step", "make_dp_train_step"):
        assert hasattr(dp, name) and hasattr(jdp, name), name


@pytest.mark.parametrize("num_limbs", [1, 2, 3, 4])
def test_pack_int8_limbs_matches_jax(num_limbs):
    g = _full_range((64, 33), seed=num_limbs)
    got = compress.pack_int8_limbs(torch.from_numpy(g), num_limbs)
    _eq(got, jcompress.pack_int8_limbs(jnp.asarray(g), num_limbs))
    assert got.shape == (num_limbs, 64, 33) and got.dtype == torch.int8
    if num_limbs == 4:  # the full encoding round-trips every int32
        _eq(compress.unpack_limb_sums(got.to(torch.int32), 1), g)


@pytest.mark.parametrize("num_limbs", [0, 5])
def test_pack_int8_limbs_rejects_limb_count(num_limbs):
    with pytest.raises(ValueError, match="num_limbs"):
        compress.pack_int8_limbs(torch.zeros(3, dtype=torch.int32), num_limbs)


@pytest.mark.parametrize("shards", [1, 2, 4, 1000])
def test_unpack_limb_sums_matches_jax(shards):
    """Plane sums of ``shards`` full-range tensors recombine to their int32
    sum (mod 2³²), as JAX's do, for every limb count; and any full-range
    plane sums (INT32_MIN/MAX planted) recombine as JAX's do."""
    width = 4096 if shards < 1000 else 64
    parts = [_full_range(width, seed=100 * shards + i) for i in range(shards)]
    want = np.zeros(width, np.int64)
    for p in parts:
        want += p
    want = ((want + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    for num_limbs in (1, 2, 3, 4):
        planes = sum(compress.pack_int8_limbs(torch.from_numpy(p), num_limbs).to(torch.int32)
                     for p in parts)
        got = compress.unpack_limb_sums(planes, shards)
        _eq(got, jcompress.unpack_limb_sums(jnp.asarray(planes.numpy()), shards),
            f"{num_limbs} limbs")
        if num_limbs == 4:
            _eq(got, want)
        sums = _full_range((num_limbs, width), seed=7 + num_limbs)
        _eq(compress.unpack_limb_sums(torch.from_numpy(sums), shards),
            jcompress.unpack_limb_sums(jnp.asarray(sums), shards), f"raw {num_limbs}")


@pytest.mark.parametrize("num_limbs", [1, 2, 3, 4])
def test_fits_limbs_matches_jax(num_limbs):
    bound = 1 << (8 * num_limbs - 1)
    cases = [_full_range(257, seed=num_limbs),
             np.random.default_rng(num_limbs).integers(-bound, bound, 257).astype(np.int32)]
    if num_limbs < 4:
        cases += [np.array([bound - 1, -bound], np.int32), np.array([bound], np.int32),
                  np.array([-bound - 1], np.int32)]
    for g in cases:
        got = compress.fits_limbs(torch.from_numpy(g), num_limbs)
        _eq(got, jcompress.fits_limbs(jnp.asarray(g), num_limbs), g[:4])
    assert bool(compress.fits_limbs(torch.tensor([INT32_MIN, INT32_MAX]), 4))


def test_ef_compress_decompress_matches_jax():
    """Payload, power-of-two scale and residual bitwise JAX's over two EF
    rounds (the second reads the first's residual)."""
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((16, 9)).astype(np.float32) * 3,
         "b": rng.standard_normal(40).astype(np.float32) * 1e-4,
         "c": np.zeros(5, np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    t_ef, j_ef = compress.ef_init(tg), jcompress.ef_init(jg)
    for _ in range(2):
        tq, ts, t_ef = compress.compress(tg, t_ef)
        jq, js, j_ef = jcompress.compress(jg, j_ef)
        for k in g:
            _eq(tq[k], jq[k], f"payload {k}")
            _eq(ts[k], js[k], f"scale {k}")
            _eq(t_ef.residual[k], j_ef.residual[k], f"residual {k}")
            s = float(ts[k])
            assert s == 2.0 ** round(np.log2(s))  # a power of two
            _eq(compress.decompress(tq, ts)[k], jcompress.decompress(jq, js)[k])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rule_tables_equal_jax(multi_pod):
    assert sharding.train_rules(multi_pod) == jsharding.train_rules(multi_pod)
    assert sharding.serve_rules(multi_pod) == jsharding.serve_rules(multi_pod)


def _spec(entries) -> tuple:
    """Spec entries with a one-axis tuple written as its name, as JAX's
    ``PartitionSpec`` writes it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def test_resolve_inside_and_outside_use_rules():
    axes = ("batch", None, "mlp", "no_such_axis")
    assert sharding.resolve(axes) == tuple(jsharding.resolve(axes)) == ()
    mesh = jax.make_mesh((1,), ("data",))
    for rules in (jsharding.train_rules(), jsharding.serve_rules(True)):
        with jsharding.use_rules(mesh, rules):
            want = tuple(jsharding.resolve(axes))
        with sharding.use_rules(dp.data_mesh(1), rules):
            assert _spec(sharding.resolve(axes)) == want
            with sharding.use_rules(None, {"batch": "x"}):  # nests, then restores
                assert sharding.resolve(("batch",)) == ("x",)
            assert _spec(sharding.resolve(axes)) == want
        assert sharding.resolve(axes) == ()
    with sharding.use_rules(dp.data_mesh(1), sharding.train_rules()):
        assert sharding.resolve(("batch",)) == (("data",),)


def test_tree_leaves_follow_jax_order():
    jcfg = _tiny("jax")
    js = jles.create_train_state(jax.random.PRNGKey(0), jcfg)
    ts = tles.create_train_state(prng.PRNGKey(0), _tiny("torch"), device="cpu")
    t_leaves, j_leaves = tree.leaves(ts), jax.tree_util.tree_leaves(js)
    assert len(t_leaves) == len(j_leaves) == 2 * len(jcfg.blocks) + 1 + 5
    for t, j in zip(t_leaves, j_leaves):
        _eq(t, j)
    doubled = tree.tree_map(lambda a: a * 2, ts)
    assert type(doubled) is type(ts) and type(doubled.opt_lr) is type(ts.opt_lr)
    assert list(doubled.params) == list(ts.params)
    assert torch.equal(doubled.params["output"]["w"], ts.params["output"]["w"] * 2)


# ---------------------------------------------------------------------------
# One rank, and the rejections
# ---------------------------------------------------------------------------


def _tiny(pkg):
    """``tiny_dp_cfg`` of ``tests/test_data_parallel.py``: dropout on both blocks."""
    spec, cfg = (JBlockSpec, JNitroConfig) if pkg == "jax" else (TBlockSpec, TNitroConfig)
    return cfg(blocks=(spec(kind="conv", out_features=16, pool=True, d_lr=256, dropout=0.1),
                       spec(kind="linear", out_features=64, dropout=0.1)),
               input_shape=(8, 8, 3), num_classes=10, gamma_inv=512)


def _toy_batch(cfg, batch=8):
    rng = np.random.default_rng(0)
    return (rng.integers(-128, 128, (batch, *cfg.input_shape)).astype(np.int32),
            rng.integers(0, cfg.num_classes, (batch,)).astype(np.int32))


def test_one_rank_axis_and_collectives_are_the_identity():
    axis = dp.data_mesh(1)
    assert axis == dp.data_mesh() == dp.DataAxis("data", None, 0, 1, None)
    assert collectives.axis_size(axis) == 1
    x = torch.arange(10, dtype=torch.int32).reshape(5, 2)
    for fn in (collectives.ring_reduce_scatter, collectives.ring_all_gather,
               collectives.ring_all_reduce, collectives.all_reduce):
        assert fn(x, axis) is x
    assert torch.equal(compress.nitro_compressed_psum(x, axis), x)
    assert torch.equal(dp.shard_batch(x, axis), x)


@pytest.mark.parametrize("reducer", REDUCERS)
def test_one_rank_dp_step_is_the_train_step(reducer):
    """At one rank every reducer's step is ``les.train_step`` bit for bit,
    telemetry's readout included (its ``dp`` entry: 1 shard)."""
    cfg = _tiny("torch")
    x, y = (torch.from_numpy(a) for a in _toy_batch(cfg))
    axis = dp.data_mesh(1)
    ref = got = tles.create_train_state(prng.PRNGKey(0), cfg, device="cpu")
    for i in range(2):
        key = prng.PRNGKey(100 + i)
        ref, rm, rt = tles.train_step(ref, cfg, x, y, key, telemetry=True)
        got, gm, gt = dp.make_dp_train_step(cfg, axis, dp_reduce=reducer,
                                            telemetry=True)(got, x, y, key)
        extra = gt.pop("dp")
        assert int(extra["shards"]) == 1 and int(extra["grad_fits_int16"]) in (0, 1)
        for a, b in zip(tree.leaves((got, gm, gt)), tree.leaves((ref, rm, rt)), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_unknown_reducer_rejected():
    cfg = _tiny("torch")
    x, y = (torch.from_numpy(a) for a in _toy_batch(cfg))
    state = tles.create_train_state(prng.PRNGKey(0), cfg, device="cpu")
    axis = dp.data_mesh(1)
    with pytest.raises(ValueError, match="dp_reduce"):
        dp.dp_train_step(state, cfg, x, y, prng.PRNGKey(0), axis=axis, dp_reduce="avg")
    with pytest.raises(ValueError, match="dp_reduce"):
        dp.reduce_gradients({"w": x}, axis, "avg")
    with pytest.raises(ValueError, match="dp_reduce"):
        dp.make_dp_train_step(cfg, axis, dp_reduce="avg")


def test_too_many_ranks_rejected():
    with pytest.raises(ValueError, match="--num-devices 2"):
        dp.data_mesh(2)


def test_batch_not_divisible_rejected():
    axis = dp.DataAxis("data", None, 1, 3, "gloo")
    with pytest.raises(ValueError, match="batch 8 not divisible"):
        dp.shard_batch(torch.zeros(8, 2), axis)
    rows = dp.shard_batch(torch.arange(9), axis)
    assert rows.tolist() == [3, 4, 5]


def test_rank_devices_and_backend():
    assert dp.rank_devices(3, "cpu") == ("gloo", [torch.device("cpu")] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dp.rank_devices(2)
    assert dp.describe("gloo", [torch.device("cuda", 0)] * 2) == (
        "backend gloo, rank→device 0→cuda:0 1→cuda:0")


# ---------------------------------------------------------------------------
# gloo worlds of 2 and 4 ranks against JAX's single-device step
# ---------------------------------------------------------------------------


class _Worlds:
    """The two worlds, started at once; ``get(n)`` waits for one."""

    def __init__(self, out_dir: Path):
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
        self.out_dir, self.procs, self.done = out_dir, {}, {}
        for n in (2, 4):
            self.procs[n] = subprocess.Popen(
                [sys.executable, str(WORLD), "--ranks", str(n),
                 "--out", str(out_dir / f"w{n}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def get(self, n: int) -> dict:
        if n not in self.done:
            out, _ = self.procs[n].communicate(timeout=600)
            assert self.procs[n].returncode == 0, out
            with np.load(self.out_dir / f"w{n}.npz") as z:
                self.done[n] = {k: z[k] for k in z.files}
        return self.done[n]

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = _Worlds(tmp_path_factory.mktemp("dp_worlds"))
    yield w
    w.close()


def _jax_run(cfg, steps, telemetry=False) -> dict:
    """JAX's single-device ``les.train_step`` on the worker's batch: the
    per-step metrics (and telemetry leaves) and the final state leaves,
    named as the world names them."""
    x, y = _toy_batch(cfg)
    state = jles.create_train_state(jax.random.PRNGKey(0), cfg)
    step = jax.jit(functools.partial(jles.train_step, cfg=cfg, backend="reference",
                                     telemetry=telemetry))
    out = {}
    for i in range(steps):
        res = step(state, x=jnp.asarray(x), labels=jnp.asarray(y),
                   key=jax.random.PRNGKey(100 + i))
        state, metrics = res[0], res[1]
        for f, v in metrics._asdict().items():
            out[f"step{i}/{f}"] = np.asarray(v)
        if telemetry:
            for j, leaf in enumerate(jax.tree_util.tree_leaves(res[2])):
                out[f"step{i}/telem_{j:03d}"] = np.asarray(leaf)
    for j, leaf in enumerate(jax.tree_util.tree_leaves(state)):
        out[f"state_{j:03d}"] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def jax_refs(worlds):
    """Computed while the worlds run (``worlds`` starts them first).  The
    tiny net's plain reference is its telemetry run without the telemetry
    leaves: JAX's telemetry step keeps the trajectory bitwise (its own
    tests hold that)."""
    vgg = jpaper.get("vgg8b", scale=0.0625, input_shape=(16, 16, 3))
    telem = _jax_run(_tiny("jax"), 3, telemetry=True)
    return {"tiny": {k: v for k, v in telem.items() if "/telem_" not in k},
            "vgg8b": _jax_run(vgg, 2), "tiny-telemetry": telem}


def _assert_cell(world: dict, n: int, cell: str, want: dict) -> None:
    for r in range(n):
        got = {k[len(f"r{r}/{cell}/"):]: v for k, v in world.items()
               if k.startswith(f"r{r}/{cell}/") and "/dp_" not in k}
        assert sorted(got) == sorted(want), (r, cell)
        for k in want:
            _eq(got[k], want[k], f"rank {r} {cell} {k}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("reducer", REDUCERS)
@pytest.mark.parametrize("config", ["tiny", "vgg8b"])
def test_trajectory_is_the_single_device_one(worlds, jax_refs, config, reducer, n):
    _assert_cell(worlds.get(n), n, f"{config}-{reducer}", jax_refs[config])


def test_fuse_opt_two_ranks_is_the_single_device_one(worlds, jax_refs):
    """The post-reduce fused IntegerSGD apply at 2 ranks ≡ the plain
    single-device trajectory."""
    _assert_cell(worlds.get(2), 2, "tiny-psum-fuse_opt", jax_refs["tiny"])


def test_telemetry_four_ranks_is_the_single_device_readout(worlds, jax_refs):
    world = worlds.get(4)
    _assert_cell(world, 4, "tiny-telemetry", jax_refs["tiny-telemetry"])
    for r in range(4):
        for i in range(3):
            assert int(world[f"r{r}/tiny-telemetry/step{i}/dp_shards"]) == 4
            fits = world[f"r{r}/tiny-telemetry/step{i}/dp_grad_fits_int16"]
            assert fits.dtype == np.int32 and int(fits) in (0, 1)
            assert fits == world[f"r0/tiny-telemetry/step{i}/dp_grad_fits_int16"]


def _rank_data(r, shape, seed):
    return np.random.default_rng(seed + r).integers(-(2 ** 20), 2 ** 20, shape).astype(np.int32)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_chunks_rank_order_and_ragged_rows(worlds, n):
    world = worlds.get(n)
    xs = [_rank_data(r, (3 * n, 5), 10) for r in range(n)]
    total = sum(x.astype(np.int64) for x in xs).astype(np.int32)
    odd_total = sum(_rank_data(r, (7, 3), 20) for r in range(n))
    for r in range(n):
        _eq(world[f"r{r}/ring/x_untouched"], xs[r])
        _eq(world[f"r{r}/ring/reduce_scatter"], total[3 * r:3 * (r + 1)], f"chunk {r}")
        _eq(world[f"r{r}/ring/all_gather"], total, f"gather {r}")
        _eq(world[f"r{r}/ring/all_reduce_ring"], world[f"r{r}/ring/all_reduce"])
        _eq(world[f"r{r}/ring/all_reduce"], odd_total)


@pytest.mark.parametrize("n", [2, 4])
def test_every_reducer_wraps_int32_as_xla(worlds, n):
    """INT32_MAX + 1 is INT32_MIN through psum, the ring and the limb
    planes, as XLA's int32 psum gives; 2 limbs are exact within int16."""
    world = worlds.get(n)
    for r in range(n):
        for red in ("psum", "ring", "compress"):
            _eq(world[f"r{r}/wrap/{red}"], np.array([INT32_MIN, -5 * n], np.int32), red)
        _eq(world[f"r{r}/wrap/compress2"], np.array([1001, -5 * n], np.int32))


def test_two_rank_cli_resume_is_the_one_device_resume(worlds):
    """Every rank restores from ``--ckpt-dir`` (rank 0 alone writes it): the
    second two-rank CLI call resumes from step 2 and ends where one device
    ends with the launcher's resume semantics — keys ``PRNGKey(2 + it)`` on
    the first call's batches again."""
    import itertools

    from repro_torch.configs import get_paper_config
    from repro_torch.data import synthetic

    world = worlds.get(2)
    assert world["cli-resume/start_steps"].tolist() == [0, 2]
    ds = synthetic.make_image_dataset("tiles32", n_train=4096, n_test=512, seed=0)
    cfg = get_paper_config("vgg8b", scale=0.0625, input_shape=ds.input_shape)
    batches = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in
               itertools.islice(synthetic.batches(ds.x_train, ds.y_train, 8, seed=0), 2)]
    state = tles.create_train_state(prng.PRNGKey(0), cfg, device="cpu")
    for start in (0, 2):
        metrics = []
        for it, (x, y) in enumerate(batches):
            state, m = tles.train_step(state, cfg, x, y, prng.PRNGKey(start + it))
            metrics.append(m)
    want = tree.leaves((state, metrics))
    got = sorted(k for k in world if k.startswith("cli-resume/leaf_"))
    assert len(got) == len(want) > 0
    for k, leaf in zip(got, want):
        _eq(world[k], leaf.numpy(), k)


@pytest.mark.parametrize("n", [2, 4])
def test_ef_compressed_psum_matches_jax_vmap(worlds, n):
    """Every rank's EF all-reduce (sum and residual) ≡ JAX's
    ``compressed_psum`` over the same per-rank gradients under ``vmap``."""
    world = worlds.get(n)
    a = np.stack([np.random.default_rng(30 + r).standard_normal((6, 5)).astype(np.float32)
                  for r in range(n)])
    b = np.stack([np.random.default_rng(40 + r).standard_normal(9).astype(np.float32) * 1e-3
                  for r in range(n)])

    def one(a, b):
        g = {"a": a, "b": b}
        red, ef = jcompress.compressed_psum(g, jcompress.ef_init(g), "data")
        return red["a"], red["b"], ef.residual["a"], ef.residual["b"]

    sa, sb, ra, rb = jax.vmap(one, axis_name="data")(jnp.asarray(a), jnp.asarray(b))
    for r in range(n):
        _eq(world[f"r{r}/ef/sum_a"], sa[r])
        _eq(world[f"r{r}/ef/sum_b"], sb[r])
        _eq(world[f"r{r}/ef/res_a"], ra[r])
        _eq(world[f"r{r}/ef/res_b"], rb[r])
