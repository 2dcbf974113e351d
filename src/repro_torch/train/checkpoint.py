"""Checkpoint reader for the JAX package's manifest format (port of the
read half of ``repro.train.checkpoint``).

Layout::

    ckpt_dir/
      step_00000100/
        MANIFEST.json        # step, leaf index (key path → file), status
        leaf_00000.npy ...   # one file per pytree leaf
      LATEST                 # name of the newest COMPLETE checkpoint

A checkpoint is valid iff its manifest says ``status: COMPLETE``.  Leaves
are keyed by the JAX key-path string, e.g. ``"[0]/['w']"`` for the first
layer of a frozen model, and come back as numpy arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np


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


def restore(ckpt_dir: str, paths: list[str], *,
            step: int | None = None) -> tuple[list[np.ndarray], int]:
    """Load the leaves named by ``paths`` (JAX key-path strings).

    ``step=None`` restores the newest COMPLETE checkpoint.  Returns the
    arrays in the order of ``paths`` and the step restored.
    """
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
        arr = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", entry["file"]))
        out.append(arr)
    return out, step
