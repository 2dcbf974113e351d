"""Freeze a NITRO-D model into an immutable inference artifact (port of
``repro.infer.export``).

A ``FrozenModel`` keeps the forward-layer weights of every block (the
learning layers are dropped, paper §E.3), each narrowed to the smallest
integer dtype that holds it losslessly, plus each layer's scale factor,
NITRO-ReLU α_inv and pooling flag.  Its weights live on the host;
``compile_plan`` places them on the device.

On disk a frozen model is a ``train.checkpoint`` manifest directory
(format ``nitro-frozen-v1``) whose ``extra`` field carries the topology,
with ``QUANT_REPORT.json`` (``quantization_report``, the paper's §4.4
bit-growth view) beside the manifest — the JAX package's format, so a
directory written by either package's ``save_frozen`` loads in both, and
the report is byte for byte the JAX package's.  ``save_fleet_manifest``
/ ``load_fleet_manifest`` read and write ``FLEET.json``, a directory of
frozen models served as one unit.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core.activations import relu_fits_int8
from repro_torch.core.scaling import conv_scale_factor, linear_scale_factor
from repro_torch.train import checkpoint as ckpt

FORMAT = "nitro-frozen-v1"


class FrozenLayer(NamedTuple):
    """One inference layer: fused matmul → scale → (optional) ReLU/pool."""

    kind: str            # 'conv' | 'linear' | 'output'
    w: torch.Tensor      # (K,K,C,F) conv / (M,N) linear — narrowest dtype, host
    sf: int              # NITRO scale factor for the producing matmul
    alpha_inv: int       # NITRO-ReLU leak (ignored when apply_relu=False)
    apply_relu: bool
    pool: bool           # MaxPool2D(2,2) after the activation (conv only)


class FrozenModel(NamedTuple):
    layers: tuple[FrozenLayer, ...]
    input_shape: tuple[int, ...]   # per-sample shape, e.g. (32,32,3)
    num_classes: int
    name: str

    def num_bytes(self) -> int:
        return sum(l.w.numel() * l.w.element_size() for l in self.layers)


def _narrow(w) -> torch.Tensor:
    """Host copy in the smallest integer dtype holding every value."""
    arr = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    lo, hi = int(arr.min()), int(arr.max())
    for dt in (np.int8, np.int16):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return torch.from_numpy(arr.astype(dt))
    return torch.from_numpy(arr.astype(np.int32))


def _layer_sf(kind: str, w: torch.Tensor) -> int:
    """Scale factor from weight geometry — matches core.blocks exactly."""
    if kind == "conv":
        k, _, c_in, _ = w.shape
        return conv_scale_factor(k, c_in)
    return linear_scale_factor(w.shape[0])


def freeze(state_or_params, cfg: M.NitroConfig) -> FrozenModel:
    """TrainState (or raw params dict) + config → immutable FrozenModel."""
    params = getattr(state_or_params, "params", state_or_params)
    if len(params["blocks"]) != len(cfg.blocks):
        raise ValueError(
            f"params have {len(params['blocks'])} blocks, "
            f"config describes {len(cfg.blocks)}"
        )
    layers: list[FrozenLayer] = []
    for spec, p in zip(cfg.blocks, params["blocks"]):
        w = _narrow(p["fw"]["w"])
        layers.append(FrozenLayer(
            kind=spec.kind, w=w, sf=_layer_sf(spec.kind, w),
            alpha_inv=spec.alpha_inv, apply_relu=True,
            pool=bool(spec.pool and spec.kind == "conv"),
        ))
    w_out = _narrow(params["output"]["w"])
    layers.append(FrozenLayer(
        kind="output", w=w_out, sf=_layer_sf("output", w_out),
        alpha_inv=0, apply_relu=False, pool=False,
    ))
    return FrozenModel(
        layers=tuple(layers),
        input_shape=tuple(cfg.input_shape),
        num_classes=cfg.num_classes,
        name=cfg.name,
    )


# ---------------------------------------------------------------------------
# Quantisation report — per-layer bit-width/histogram (paper §4.4)
# ---------------------------------------------------------------------------

REPORT_FORMAT = "nitro-quant-report-v1"
REPORT_FILENAME = "QUANT_REPORT.json"


def _twos_complement_bits(lo: int, hi: int) -> int:
    """Smallest two's-complement width holding every value in [lo, hi]."""
    bits = 1
    while lo < -(1 << (bits - 1)) or hi > (1 << (bits - 1)) - 1:
        bits += 1
    return bits


def _magnitude_histogram(arr: np.ndarray) -> dict[str, int]:
    """Counts per power-of-two magnitude bucket.

    Bucket ``"0"`` counts exact zeros; bucket ``"b"`` (b ≥ 1) counts values
    with 2^(b-1) ≤ |v| < 2^b, i.e. values whose magnitude needs exactly
    ``b`` bits.
    """
    mag = np.abs(arr.astype(np.int64))
    # |v| ≤ 2^31 ⇒ float64 log2 is exact enough for the integer floor
    bl = np.where(mag > 0, np.floor(np.log2(np.maximum(mag, 1))).astype(np.int64) + 1, 0)
    buckets, counts = np.unique(bl, return_counts=True)
    return {str(int(b)): int(c) for b, c in zip(buckets, counts)}


def quantization_report(fm: FrozenModel) -> dict:
    """Per-layer bit-width / histogram report for a FrozenModel.

    Pure metadata (JSON-serialisable): how many bits each layer occupies
    against the dtype it was narrowed to, where the values concentrate,
    and the artifact's size against a naive int32 export.  Every weight is
    read as a numpy array, so ``"dtype"`` reads ``int8`` as the JAX
    package writes it.
    """
    report_layers = []
    total_bytes = 0
    total_int32_bytes = 0
    max_bits = 0
    act_int8 = False  # the network input enters as int32
    for i, layer in enumerate(fm.layers):
        arr = layer.w.detach().cpu().numpy()
        lo, hi = int(arr.min()), int(arr.max())
        bits = _twos_complement_bits(lo, hi)
        max_bits = max(max_bits, bits)
        nbytes = int(arr.size) * arr.dtype.itemsize
        total_bytes += nbytes
        total_int32_bytes += int(arr.size) * 4
        # mirrors infer.plan's per-step operand_dtype='auto' decision
        int8_eligible = act_int8 and arr.dtype == np.int8
        act_int8 = layer.apply_relu and relu_fits_int8(layer.alpha_inv)
        report_layers.append({
            "index": i,
            "kind": layer.kind,
            "shape": [int(d) for d in arr.shape],
            "dtype": str(arr.dtype),
            "sf": layer.sf,
            "alpha_inv": layer.alpha_inv,
            "params": int(arr.size),
            "bytes": nbytes,
            "min": lo,
            "max": hi,
            "zero_fraction": float((arr == 0).mean()),
            "bit_width": bits,
            "dtype_bits": arr.dtype.itemsize * 8,
            "int8_operand_eligible": bool(int8_eligible),
            "magnitude_histogram": _magnitude_histogram(arr.ravel()),
        })
    return {
        "format": REPORT_FORMAT,
        "name": fm.name,
        "num_layers": len(fm.layers),
        "num_int8_operand_eligible": sum(
            1 for l in report_layers if l["int8_operand_eligible"]
        ),
        "max_bit_width": max_bits,
        "total_bytes": total_bytes,
        "total_int32_bytes": total_int32_bytes,
        "compression_vs_int32": (
            total_int32_bytes / total_bytes if total_bytes else 1.0
        ),
        "layers": report_layers,
    }


# ---------------------------------------------------------------------------
# Persistence — train/checkpoint manifest format, topology in `extra`
# ---------------------------------------------------------------------------


def _topology(fm: FrozenModel) -> dict:
    return {
        "format": FORMAT,
        "name": fm.name,
        "input_shape": list(fm.input_shape),
        "num_classes": fm.num_classes,
        "layers": [
            {"kind": l.kind, "sf": l.sf, "alpha_inv": l.alpha_inv,
             "apply_relu": l.apply_relu, "pool": l.pool}
            for l in fm.layers
        ],
    }


def save_frozen(path: str, fm: FrozenModel, *, step: int | None = None,
                keep_last: int | None = None) -> str:
    """Write the frozen model as a COMPLETE manifest checkpoint.

    ``step=None`` steps past the numerically newest version already in
    ``path`` (0 for a fresh directory), so a re-export appends a version
    instead of clobbering the one being served; ``load_frozen(path)``
    keeps returning the newest COMPLETE version.  ``keep_last=N`` prunes
    all but the N newest versions after the new one lands.
    ``QUANT_REPORT.json`` is written after the COMPLETE marker, so it
    never gates the checkpoint's validity.
    """
    if step is None:
        # scan the directories, not LATEST: after a rollback re-export
        # (an explicit lower step rewrote LATEST) incrementing from LATEST
        # would clobber a retained version
        existing = _step_numbers(path)
        step = max(existing) + 1 if existing else 0
    tree = [{"w": l.w} for l in fm.layers]
    step_dir = ckpt.save(path, step, tree, extra=_topology(fm))
    with open(os.path.join(step_dir, REPORT_FILENAME), "w") as f:
        json.dump(quantization_report(fm), f, indent=2)
    if keep_last is not None:
        prune_frozen(path, keep_last=keep_last)
    return step_dir


def prune_frozen(path: str, *, keep_last: int) -> list[int]:
    """Delete all but the ``keep_last`` newest versions; returns the steps
    pruned.  The step ``LATEST`` names is always kept, even when it is not
    the newest (a rollback re-export rewrites ``LATEST`` to a lower step).
    Prune from the single writer that owns the directory: a reader pinning
    an old ``step`` races with its deletion."""
    if keep_last < 1:
        raise ValueError("keep_last must be >= 1")
    latest = ckpt.latest_step(path)
    steps = _step_numbers(path)
    pruned = [s for s in steps[:-keep_last] if s != latest]
    for s in pruned:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"))
    return pruned


def _step_numbers(path: str) -> list[int]:
    """Ascending step numbers of every ``step_NNNNNNNN`` dir in ``path``."""
    if not os.path.isdir(path):
        return []
    return sorted(
        int(m.group(1))
        for name in os.listdir(path)
        if (m := re.fullmatch(r"step_(\d{8})", name))
    )


def load_frozen(path: str, *, step: int | None = None) -> FrozenModel:
    """Load a ``save_frozen`` directory; validates the format.

    ``step=None`` loads the newest COMPLETE version; an explicit ``step``
    pins one (e.g. rolling back a bad hot-swap).
    """
    if step is None:
        step = ckpt.latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no COMPLETE frozen model in {path}")
    meta = ckpt.read_manifest(path, step)["extra"]
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path} is not a frozen NITRO model "
            f"(format={meta.get('format')!r}, expected {FORMAT!r})"
        )
    # save_frozen stores the list [{"w": ...}, ...] — JAX key paths "[i]/['w']"
    leaf_paths = [f"[{i}]/['w']" for i in range(len(meta["layers"]))]
    arrays, _ = ckpt.restore_leaves(path, leaf_paths, step=step)
    layers = []
    for lm, arr in zip(meta["layers"], arrays):
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"{path}: frozen weight has dtype {arr.dtype}")
        layers.append(FrozenLayer(
            kind=lm["kind"], w=torch.from_numpy(np.ascontiguousarray(arr)),
            sf=int(lm["sf"]), alpha_inv=int(lm["alpha_inv"]),
            apply_relu=bool(lm["apply_relu"]), pool=bool(lm["pool"]),
        ))
    return FrozenModel(
        layers=tuple(layers),
        input_shape=tuple(meta["input_shape"]),
        num_classes=int(meta["num_classes"]),
        name=meta["name"],
    )


# ---------------------------------------------------------------------------
# Fleet manifest — a directory of frozen models served as one unit
# ---------------------------------------------------------------------------

FLEET_FORMAT = "nitro-fleet-v1"
FLEET_FILENAME = "FLEET.json"


def save_fleet_manifest(
    root: str,
    models: dict[str, str],
    *,
    splits: dict[str, dict[str, float]] | None = None,
) -> str:
    """Write ``FLEET.json`` describing a multi-model serving fleet.

    ``models`` maps model id → frozen-model directory (absolute, or
    relative to ``root``, which keeps the fleet relocatable).  ``splits``
    maps a routing alias → {model id: weight}; every arm must name a model
    in ``models``.  ``serving.registry.ModelRegistry.from_manifest`` turns
    the manifest into compiled plans.
    """
    _validate_fleet(models, splits or {})
    os.makedirs(root, exist_ok=True)
    payload = {
        "format": FLEET_FORMAT,
        "models": dict(models),
        "splits": {a: dict(w) for a, w in (splits or {}).items()},
    }
    path = os.path.join(root, FLEET_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: readers never see a torn manifest
    return path


def _validate_fleet(models: dict, splits: dict) -> None:
    """Manifest invariants, enforced on write AND read: a hand-edited
    FLEET.json fails once at load, not when traffic first hashes onto a
    broken arm."""
    if not models:
        raise ValueError("fleet manifest needs at least one model")
    for alias, arms in splits.items():
        missing = sorted(set(arms) - set(models))
        if missing:
            raise ValueError(
                f"split {alias!r} references unknown models: {missing}"
            )
        if alias in models:
            raise ValueError(f"split alias {alias!r} shadows a model id")


def load_fleet_manifest(root: str) -> dict:
    """Read and validate ``FLEET.json``; model paths resolved under root."""
    path = os.path.join(root, FLEET_FILENAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {FLEET_FILENAME} in {root}")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("format") != FLEET_FORMAT:
        raise ValueError(
            f"{path} is not a fleet manifest "
            f"(format={meta.get('format')!r}, expected {FLEET_FORMAT!r})"
        )
    splits = meta.get("splits", {})
    _validate_fleet(meta["models"], splits)
    models = {
        mid: d if os.path.isabs(d) else os.path.join(root, d)
        for mid, d in meta["models"].items()
    }
    return {"models": models, "splits": splits}
