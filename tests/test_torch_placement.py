"""PyTorch port, the placements of the dry run ≡ the JAX package's, on the
CPU: ``parallel.sharding``'s ``named_sharding`` / ``tree_shardings`` /
``local_shape`` / ``shard`` against JAX's ``NamedSharding`` on an
``AbstractMesh`` (the production meshes without 256 devices), every arch's
parameter and cache placements under the dry run's rules for train and
serve on one pod and two, the dry run's ``make_rules``, the logical meshes
of ``launch/mesh.py``, the trainer's batch placements and
``fault_tolerance.ElasticPolicy``.
"""

import os

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget
from repro.launch import shapes as jS
from repro.models import transformer as jT
from repro.parallel import sharding as jshr
from repro.train import fault_tolerance as jft
from repro.train import trainer as jtr
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tT
from repro_torch.parallel import sharding as tshr
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import trainer as ttr


@pytest.fixture(scope="module")
def jax_make_rules():
    """JAX's ``repro.launch.dryrun.make_rules``.  The module sets
    ``XLA_FLAGS`` when imported: the variable is restored after the module,
    so no later subprocess of the worker inherits it, and JAX's backend is
    up before it, so this process keeps its one device."""
    jax.devices()
    mp = pytest.MonkeyPatch()
    mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    try:
        from repro.launch.dryrun import make_rules
        yield make_rules
    finally:
        mp.undo()


def _jmesh(multi_pod: bool) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _flat(tree) -> list:
    """The port's placement tree's leaves, in ``jax.tree_util`` order."""
    if isinstance(tree, tshr.NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [x for v in tree for x in _flat(v)]


def _shard_shape_or_error(fn):
    try:
        return tuple(fn())
    except ValueError:
        return "uneven"


def _hold(port_tree, jax_tree, shapes) -> int:
    """Each leaf's spec and local shape: the port's ≡ JAX's."""
    got = _flat(port_tree)
    want = jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want) == len(shapes)
    for g, w, shape in zip(got, want, shapes):
        assert g.spec == tuple(w.spec), (g.spec, w.spec)
        assert _shard_shape_or_error(lambda: g.shard_shape(shape)) == \
            _shard_shape_or_error(lambda: w.shard_shape(shape)), (shape, g.spec)
    return len(got)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_cache_placements_equal_jax(arch, multi_pod, jax_make_rules):
    """Parameters under the train and serve rules, the decode_32k cache
    under the serve rules: every leaf's spec and per-chip shape."""
    jcfg, tcfg = jget(arch), tget(arch)
    jm, tm = _jmesh(multi_pod), tmesh.make_production_mesh(multi_pod=multi_pod)
    p_shapes = [tuple(s.shape) for s in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jT.init_params(jax.random.PRNGKey(0), jcfg)))]
    for mode, batch in (("train", 256), ("serve", 128)):
        jr = jax_make_rules(jcfg, mode=mode, multi_pod=multi_pod, batch=batch)
        tr = dryrun.make_rules(tcfg, mode=mode, multi_pod=multi_pod, batch=batch)
        assert tr == jr
        _hold(ttr.param_shardings(tcfg, tm, tr), jtr.param_shardings(jcfg, jm, jr), p_shapes)
    cache = jS.abstract_cache(jcfg, 128, 32768)
    c_shapes = [tuple(s.shape) for s in jax.tree_util.tree_leaves(cache)]
    _hold(tshr.tree_shardings(tm, tr, tT.cache_logical_axes(tcfg)),
          jshr.tree_shardings(jm, jr, jT.cache_logical_axes(jcfg)), c_shapes)


@pytest.mark.parametrize("arch", list_archs())
def test_make_rules_equal_jax(arch, jax_make_rules):
    jcfg, tcfg = jget(arch), tget(arch)
    for mode in ("train", "serve"):
        for multi_pod in (False, True):
            for batch in (1, 32, 128, 256):
                assert dryrun.make_rules(tcfg, mode=mode, multi_pod=multi_pod, batch=batch) \
                    == jax_make_rules(jcfg, mode=mode, multi_pod=multi_pod, batch=batch)


@pytest.mark.parametrize("axes,shape", [
    (("batch", None), (256, 7)),
    (("batch", "heads"), (256, 32)),
    (("heads", "batch"), (48, 256)),
    (("p_fsdp", "p_heads", None), (2048, 32, 64)),
    (("vocab",), (128256,)),
    (("vocab",), (100,)),            # 16 does not divide 100
    ((None, None), (3, 5)),
    ((), (3, 5)),
    (("batch",), (256, 4, 4)),       # spec shorter than the shape
])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_named_sharding_and_local_shape_equal_jax(axes, shape, multi_pod):
    rules = tshr.train_rules(multi_pod)
    jm, tm = _jmesh(multi_pod), tmesh.make_production_mesh(multi_pod=multi_pod)
    got = tshr.named_sharding(tm, rules, axes)
    want = jshr.named_sharding(jm, rules, axes)
    assert got.spec == tuple(want.spec)
    assert _shard_shape_or_error(lambda: got.shard_shape(shape)) == \
        _shard_shape_or_error(lambda: want.shard_shape(shape))
    assert _shard_shape_or_error(lambda: tshr.local_shape(shape, got.spec, tm)) == \
        _shard_shape_or_error(lambda: NamedSharding(jm, want.spec).shard_shape(shape))


def test_specs_jax_refuses_are_refused():
    """A spec naming an axis the mesh lacks, or one axis twice, raises in
    both packages."""
    jm, tm = _jmesh(False), tmesh.make_production_mesh()
    for spec in (("pod",), ("data", "data"), (("data", "model"), "model")):
        with pytest.raises(Exception):  # a ValueError, or JAX's DuplicateSpecError
            NamedSharding(jm, P(*spec))
        with pytest.raises(ValueError):
            tshr.local_shape((256, 256), spec, tm)
        with pytest.raises(ValueError):
            tshr.named_sharding(tm, {"a": spec[0], "b": spec[-1]}, ("a", "b")
                                if len(spec) == 2 else ("a",))


def test_shard_is_the_identity_and_checks_its_axes():
    import torch

    x = torch.arange(6).reshape(2, 3)
    assert tshr.shard(x, "batch", None) is x            # no context: JAX's no-op
    tm = tmesh.make_production_mesh()
    with tshr.use_rules(tm, tshr.train_rules()):
        assert tshr.shard(x, "batch", "heads") is x
    with tshr.use_rules(tm, {"batch": ("pod", "data")}):  # no "pod" in the mesh
        with pytest.raises(ValueError):
            tshr.shard(x, "batch")


def test_tree_shardings_descends_containers_like_jax():
    """Leaves are tuples of axis names; dicts, lists and NamedTuples are
    descended (``tests/test_parallel.py``'s case, and a cache NamedTuple)."""
    logical = {"x": ("batch", None), "nested": {"w": ("heads",)},
               "l": [("vocab", None), (None,)]}
    jm, tm = _jmesh(False), tmesh.make_production_mesh()
    got = tshr.tree_shardings(tm, tshr.train_rules(), logical)
    want = jshr.tree_shardings(jm, jshr.train_rules(), logical)
    assert got["x"].spec == tuple(want["x"].spec) == ("data", None)
    assert got["nested"]["w"].spec == tuple(want["nested"]["w"].spec) == ("model",)
    assert [s.spec for s in got["l"]] == [tuple(s.spec) for s in want["l"]]
    cache = tT.cache_logical_axes(tget("llama3.2-1b"))
    leaf = tshr.tree_shardings(tm, tshr.serve_rules(), cache)["scan"]["u0"]
    assert type(leaf).__name__ == "LayerCache" and isinstance(leaf.k, tshr.NamedSharding)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-vl-72b", "whisper-large-v3"])
def test_batch_spec_equal_jax(arch, jax_make_rules):
    """The batch placements, M-RoPE positions (3, B, S) on their second dim."""
    jcfg, tcfg = jget(arch), tget(arch)
    for multi_pod in (False, True):
        rules = jax_make_rules(jcfg, mode="train", multi_pod=multi_pod, batch=256)
        specs = jS.train_batch_specs(jcfg, 256, 4096)
        shapes = {k: tuple(v.shape) for k, v in specs.items()}
        got = ttr.batch_spec(tcfg, tmesh.make_production_mesh(multi_pod=multi_pod), rules,
                             shapes=shapes)
        want = jtr.batch_spec(jcfg, _jmesh(multi_pod), rules, shapes=shapes)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].spec == tuple(want[k].spec), k
            assert got[k].shard_shape(shapes[k]) == tuple(want[k].shard_shape(shapes[k]))


def test_meshes_equal_jax(monkeypatch):
    """``make_production_mesh`` / ``make_test_mesh`` give JAX's shapes and
    axis names (JAX's built on an ``AbstractMesh``: no 256 devices here)."""
    from repro.launch import mesh as jmesh

    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: AbstractMesh(shape, axes))
    for multi_pod in (False, True):
        got, want = tmesh.make_production_mesh(multi_pod=multi_pod), \
            jmesh.make_production_mesh(multi_pod=multi_pod)
        assert got.shape == tuple(want.axis_sizes) and got.axis_names == want.axis_names
        assert tmesh.mesh_num_chips(got) == want.size == (512 if multi_pod else 256)
    got, want = tmesh.make_test_mesh(2, 4), jmesh.make_test_mesh(2, 4)
    assert got.shape == tuple(want.axis_sizes) and got.axis_names == want.axis_names


@pytest.mark.parametrize("shape,axes,link", [
    ((16, 16), "model", "inter-node"),      # 16 chips: two nodes of 8
    ((16, 16), "data", "inter-node"),
    ((32, 8), "model", "nvlink"),
    ((32, 8), "data", "inter-node"),
    ((2, 4), "data", "nvlink"),             # chips 0 and 4: one node
    ((2, 4), ("data", "model"), "nvlink"),
    ((4, 4), "data", "inter-node"),
    ((1, 1), "model", None),                # one chip: no collective
    ((3, 3), "model", "inter-node"),        # chips 6, 7, 8 straddle nodes
])
def test_group_link(shape, axes, link):
    assert tmesh.group_link(tmesh.make_mesh(shape, ("data", "model")), axes) == link


def test_elastic_policy_equal_jax():
    """``choose_mesh_shape`` over a grid of chip counts, errors included."""
    for mp in (1, 2, 8, 16):
        for gb in (1, 96, 256, 384):
            jp, tp = jft.ElasticPolicy(mp, gb), tft.ElasticPolicy(mp, gb)
            for chips in range(0, 600, 7):
                try:
                    want = jp.choose_mesh_shape(chips)
                except RuntimeError as e:
                    with pytest.raises(RuntimeError, match=str(e).split(" with ")[0]):
                        tp.choose_mesh_shape(chips)
                    continue
                assert tp.choose_mesh_shape(chips) == want
    assert tft.ElasticPolicy() == tft.ElasticPolicy(16, 256)
