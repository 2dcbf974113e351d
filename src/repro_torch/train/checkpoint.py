"""Checkpoints in the JAX package's manifest format (port of
``repro.train.checkpoint``): ``save`` and ``AsyncCheckpointer`` write,
``restore`` reads back into the structure of a template (a
``TrainState``), ``restore_leaves`` reads leaves by path.

Layout::

    ckpt_dir/
      step_00000100/
        MANIFEST.json        # step, leaf index (key path → file), status
        leaf_00000.npy ...   # one file per pytree leaf
      LATEST                 # name of the newest COMPLETE checkpoint

A checkpoint is valid iff its manifest says ``status: COMPLETE``; the
manifest is written last (and synced), the directory renamed into place,
then ``LATEST`` written, so a writer cut short never corrupts ``LATEST``.

Leaves are ordered and named as ``jax.tree_util.tree_flatten_with_path``
orders and names them: NamedTuple fields in their order (``.params``),
dict keys sorted (``['w']``), list and tuple items by index (``[0]``),
the keys of a path joined with ``/`` — e.g.
``.params/['blocks']/[0]/['fw']/['w']``.  So a checkpoint written by the
JAX package restores here, and one written here restores there.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def map_with_paths(tree, fn: Callable[[str, Any], Any]):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``, the leaves
    visited in JAX's order; ``None`` is an empty subtree."""

    def walk(node, keys):
        if node is None:
            return None
        if _is_namedtuple(node):
            return type(node)(*(walk(getattr(node, f), keys + [f".{f}"])
                                for f in node._fields))
        if isinstance(node, dict):
            return {k: walk(node[k], keys + [f"[{k!r}]"]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keys + [f"[{i}]"]) for i, v in enumerate(node))
        return fn("/".join(keys), node)

    return walk(tree, [])


def flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's leaf order."""
    out: list[tuple[str, Any]] = []
    map_with_paths(tree, lambda path, leaf: out.append((path, leaf)))
    return out


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf: later changes to the leaf do not reach it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: dict | None = None) -> str:
    """Synchronous checkpoint write.  Returns the checkpoint path."""
    name = f"step_{step:08d}"
    path = os.path.join(ckpt_dir, name)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    index = []
    for i, (p, leaf) in enumerate(flatten_with_paths(tree)):
        arr = leaf if isinstance(leaf, np.ndarray) else _to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        index.append({"path": p, "file": fname, "shape": list(arr.shape),
                      "dtype": str(arr.dtype)})
    manifest = {"step": step, "time": time.time(), "leaves": index,
                "extra": extra or {}, "status": "COMPLETE"}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(name)
    return path


class AsyncCheckpointer:
    """Copy the tree to the host, then write it in a daemon thread.  At most
    one save is in flight: a second waits for the first to finish."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> None:
        self.wait()
        host_tree = map_with_paths(tree, lambda _, leaf: _to_host(leaf))

        def _write():
            self.last_path = save(self.ckpt_dir, step, host_tree, extra=extra)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> int | None:
    """Step of the checkpoint ``LATEST`` names, if it is COMPLETE."""
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    manifest = os.path.join(ckpt_dir, name, "MANIFEST.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        m = json.load(f)
    return int(m["step"]) if m.get("status") == "COMPLETE" else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """The manifest of ``step``; raises unless it is COMPLETE."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "MANIFEST.json")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("status") != "COMPLETE":
        raise ValueError(f"refusing to restore partial checkpoint {path}")
    return manifest


def restore_leaves(ckpt_dir: str, paths: list[str], *,
                   step: int | None = None) -> tuple[list[np.ndarray], int]:
    """Load the leaves named by ``paths`` (JAX key-path strings) as numpy
    arrays, in the order of ``paths``.  ``step=None`` restores the newest
    COMPLETE checkpoint.  Returns the arrays and the step restored."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no COMPLETE checkpoint in {ckpt_dir}")
    manifest = read_manifest(ckpt_dir, step)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for p in paths:
        entry = by_path.get(p)
        if entry is None:
            raise KeyError(f"leaf {p!r} not in checkpoint step {step} of {ckpt_dir}")
        if entry["dtype"] == "bfloat16":
            raise ValueError(f"leaf {p!r} is bfloat16; only integer leaves are read")
        out.append(np.load(os.path.join(ckpt_dir, f"step_{step:08d}", entry["file"])))
    return out, step


def restore(ckpt_dir: str, tree_like: Any, *,
            step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (e.g. a fresh
    ``TrainState``): each leaf keeps the checkpoint's dtype and takes the
    device of the template's leaf.  Returns the tree and the step."""
    paths = [p for p, _ in flatten_with_paths(tree_like)]
    arrays, step = restore_leaves(ckpt_dir, paths, step=step)
    by_path = dict(zip(paths, arrays))

    def place(path, like):
        t = torch.from_numpy(by_path[path])  # np.load: C order, 0-d kept
        return t.to(like.device) if isinstance(like, torch.Tensor) else t

    return map_with_paths(tree_like, place), step
