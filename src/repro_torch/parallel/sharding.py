"""Logical-axis rules (port of ``repro.parallel.sharding``): one table maps
model-space axis names to mesh axes, so changing the parallelism strategy
is a dict edit, not a model edit.

Models name their tensors' axes logically (``"batch"``, ``"embed"``,
``"heads"``, ``"mlp"``, ``"kv_seq"``, ``"expert"``, …).  A rule set
installed with ``use_rules`` resolves those names against the active mesh
— in the port a ``parallel.dp.DataAxis``.  Outside any context
``resolve`` gives the empty spec, so the same code runs on one device.

``resolve`` returns the tuple of mesh axes, one entry per logical axis:
the entries of the JAX package's ``PartitionSpec`` (which writes a
one-axis tuple such as ``("data",)`` as its name).  The data-parallel
step reads ``resolve(("batch",))`` → ``(("data",),)``: dim 0 over the
``data`` axis.

Placements: ``named_sharding`` / ``tree_shardings`` map logical axes to a
``NamedSharding`` on a logical mesh (``launch.mesh.Mesh``), whose ``spec``
holds the entries of JAX's ``PartitionSpec`` (a one-axis tuple written as
its name, as ``PartitionSpec`` normalises it) and whose ``shard_shape``
(``local_shape``) is the per-chip block, as ``NamedSharding.shard_shape``
gives it.  Eager torch places nothing, so ``shard`` returns its tensor;
the dry run (``launch/dryrun.py``) reads the placements to size each
chip's share.

Rule sets:

  * ``train_rules``  — DP×TP with FSDP-style weight sharding: the TP dim of
    every weight goes to ``model``, the other dim to ``data``, batch to
    ``("pod", "data")``.
  * ``serve_rules``  — TP-only weights (replicated over ``data``), batch to
    ``("pod", "data")``, KV-cache heads to ``model``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

_state = threading.local()


def _current() -> tuple[Any, Mapping[str, Any]] | None:
    return getattr(_state, "active", None)


@contextmanager
def use_rules(mesh, rules: Mapping[str, Any]):
    """Install (mesh, logical→mesh rules) for the enclosed region."""
    prev = _current()
    _state.active = (mesh, rules)
    try:
        yield
    finally:
        _state.active = prev


def resolve(axes: Sequence[str | None]) -> tuple:
    """Logical axis names → mesh axes under the active rules (the
    ``PartitionSpec`` entries); ``()`` outside any context."""
    ctx = _current()
    if ctx is None:
        return ()
    _, rules = ctx
    return tuple(rules.get(a) if a is not None else None for a in axes)


def shard(x, *axes: str | None):
    """JAX's sharding constraint: ``x`` itself, since eager torch places
    nothing.  Under an active context on a logical mesh
    (``launch.mesh.Mesh``) the axes are still resolved and the spec
    checked against the mesh, so a spec naming an axis the mesh lacks
    raises, as ``NamedSharding`` does."""
    ctx = _current()
    if ctx is not None:
        _check_spec(ctx[0], P(*resolve(axes)))
    return x


def P(*entries) -> tuple:  # noqa: N802  (JAX's PartitionSpec name)
    """A spec: one entry per leading dim, in ``PartitionSpec``'s normal
    form (a one-axis tuple is its name)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (a name, a tuple of names or None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_spec(mesh, spec: tuple) -> None:
    names, seen = tuple(mesh.axis_names), set()
    for entry in spec:
        for a in entry_axes(entry):
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of spec {spec} is not in the mesh {names}")
            if a in seen:
                raise ValueError(f"spec {spec} maps mesh axis {a!r} to two dimensions")
            seen.add(a)


def local_shape(global_shape, spec, mesh) -> tuple[int, ...]:
    """The per-chip block of an array of ``global_shape`` placed by
    ``spec`` on ``mesh`` (``NamedSharding.shard_shape``): each dim divided
    by the product of its mesh axes' sizes, which must divide it."""
    global_shape, spec = tuple(global_shape), P(*spec)
    if len(spec) > len(global_shape):
        raise ValueError(f"spec {spec} has more entries than the shape {global_shape}")
    _check_spec(mesh, spec)
    out = []
    for i, dim in enumerate(global_shape):
        parts = 1
        for a in entry_axes(spec[i] if i < len(spec) else None):
            parts *= mesh.axis_size(a)
        if dim % parts:
            raise ValueError(f"dim {i} of {global_shape} (size {dim}) is split {parts} "
                             f"ways by spec {spec}, which does not divide it")
        out.append(dim // parts)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A placement on a logical mesh: ``spec`` holds one entry per leading
    dim (a mesh axis name, a tuple of them, or None)."""

    mesh: Any
    spec: tuple

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        return local_shape(global_shape, self.spec, self.mesh)


def named_sharding(mesh, rules: Mapping[str, Any], axes: Sequence[str | None]
                   ) -> NamedSharding:
    spec = P(*(rules.get(a) if a is not None else None for a in axes))
    _check_spec(mesh, spec)
    return NamedSharding(mesh, spec)


def _is_axes_tuple(x) -> bool:
    """A leaf is a tuple of axis names — NOT a NamedTuple of such tuples
    (caches are NamedTuples whose *fields* are the leaves)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_shardings(mesh, rules: Mapping[str, Any], logical_tree):
    """Map a tree of logical-axis tuples (dicts, lists, NamedTuples) to the
    same tree of ``NamedSharding``s."""
    if _is_axes_tuple(logical_tree):
        return named_sharding(mesh, rules, logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, rules, v) for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        subs = [tree_shardings(mesh, rules, v) for v in logical_tree]
        return type(logical_tree)(*subs) if hasattr(logical_tree, "_fields") else \
            type(logical_tree)(subs)
    raise TypeError(f"not a tree of logical axes: {type(logical_tree).__name__}")


# ---------------------------------------------------------------------------
# Rule tables.  Only ``"batch"`` is read by the wired NITRO-D data-parallel
# path (``parallel.dp``: batch → the ``data`` axis); the rest cover the
# generic transformer axes of the JAX package's tables, equal to its dicts.
# ---------------------------------------------------------------------------


def train_rules(multi_pod: bool = False) -> dict[str, Any]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        # activations
        "batch": batch,
        "seq": None,
        "seq_sp": "model",       # sequence-parallel segments between blocks
        "embed": None,
        "heads": "model",
        "kv_heads": None,
        "kv_cache_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "mlp_expert": None,
        "expert_cap": "data",     # MoE dispatch-buffer capacity dim
        # parameters: TP dim → model, FSDP storage dim → data
        "p_embed": "data",
        "p_vocab": "model",
        "p_heads": "model",
        "p_kv_heads": None,
        "p_mlp": "model",
        "p_expert": "model",
        "p_mlp_expert": None,
        "p_rnn": "model",
        "p_rnn_block": "model",
        "p_fsdp": "data",
        # recurrent / conv states
        "rnn": "model",
        "kv_seq": None,
        "stack": None,           # scan-stacked layer dim — never sharded
    }


def serve_rules(multi_pod: bool = False) -> dict[str, Any]:
    rules = train_rules(multi_pod)
    rules.update({
        "p_embed": None,   # weights TP-only at inference (replicated on data)
        "p_fsdp": None,
        "seq_sp": None,
    })
    return rules
