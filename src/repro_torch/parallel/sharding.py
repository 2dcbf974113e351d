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
``data`` axis.  Placing tensors on a mesh (the JAX package's ``shard``,
``named_sharding`` and ``tree_shardings``) needs a device mesh, which the
port does not have yet.

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
