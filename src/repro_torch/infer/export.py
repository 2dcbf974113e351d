"""Freeze a NITRO-D model into an immutable inference artifact (port of
``repro.infer.export``: ``freeze`` and ``load_frozen``).

A ``FrozenModel`` keeps the forward-layer weights of every block (the
learning layers are dropped, paper §E.3), each narrowed to the smallest
integer dtype that holds it losslessly, plus each layer's scale factor,
NITRO-ReLU α_inv and pooling flag.  Its weights live on the host;
``compile_plan`` places them on the device.

``load_frozen`` reads a directory written by the JAX package's
``save_frozen`` (format ``nitro-frozen-v1``): a checkpoint manifest whose
``extra`` field carries the topology.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import model as M
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


def freeze(params: dict, cfg: M.NitroConfig) -> FrozenModel:
    """Parameter tree + config → immutable FrozenModel."""
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


def load_frozen(path: str, *, step: int | None = None) -> FrozenModel:
    """Load a ``save_frozen`` directory; validates the format.

    ``step=None`` loads the newest COMPLETE version.
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
