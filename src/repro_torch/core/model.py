"""NITRO-D model container (port of ``repro.core.model``, inference).

A static ``NitroConfig`` plus a parameter tree of int32 tensors shaped
exactly like the JAX package's:
``{"blocks": [{"fw": {"w"}, "lr": {"w"}}, ...], "output": {"w"}}``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import blocks as B
from repro_torch.core.numerics import INT_DTYPE
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True)
class NitroConfig:
    """Static NITRO-D architecture + optimiser hyper-parameters."""

    blocks: tuple[B.BlockSpec, ...]
    input_shape: tuple[int, ...]      # per-sample shape, e.g. (32,32,3) / (784,)
    num_classes: int
    gamma_inv: int = 512              # γ_inv (learning layers / output layers)
    eta_fw: int = 0                   # η_inv^fw  (0 = no decay)
    eta_lr: int = 0                   # η_inv^lr
    name: str = "nitro-d"

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)


def init_params(generator: torch.Generator, cfg: NitroConfig, *,
                device=DEFAULT_DEVICE) -> dict:
    """Initialise every block + the output layers (integer Kaiming)."""
    device = resolve_device(device)
    params: dict = {"blocks": [], "output": None}
    shape = cfg.input_shape
    for spec in cfg.blocks:
        p, shape = B.init_block(generator, spec, shape, cfg.num_classes,
                                device=device)
        params["blocks"].append(p)
    feat = 1
    for d in shape:
        feat *= d
    params["output"] = B.init_output(generator, feat, cfg.num_classes,
                                     device=device)
    return params


def params_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> dict:
    """Carry a JAX parameter tree (as numpy arrays) across to the port.

    ``tree`` is ``{"blocks": [{"fw": {"w"}, "lr": {"w"}}], "output": {"w"}}``
    of integer arrays; the result has the same structure with int32
    tensors on ``device``.
    """
    device = resolve_device(device)

    def conv(a):
        arr = np.asarray(a)
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"parameter must be integer, got {arr.dtype}")
        return torch.from_numpy(arr.astype(np.int32)).to(device)

    return {
        "blocks": [
            {"fw": {"w": conv(b["fw"]["w"])}, "lr": {"w": conv(b["lr"]["w"])}}
            for b in tree["blocks"]
        ],
        "output": {"w": conv(tree["output"]["w"])},
    }


def frozen_forward(params: dict, cfg: NitroConfig, x) -> torch.Tensor:
    """Inference logits on frozen params: the unfused reference composition.

    The oracle the fused plan is held against — it calls no kernel.
    """
    device = params["output"]["w"].device
    a = torch.as_tensor(x).to(device=device, dtype=INT_DTYPE)
    for spec, p in zip(cfg.blocks, params["blocks"]):
        a = B.forward_layers(p, spec, a)
    return B.output_forward(params["output"], a)


def predict(params: dict, cfg: NitroConfig, x) -> torch.Tensor:
    """Predicted labels (int32, as the JAX package's argmax returns)."""
    return frozen_forward(params, cfg, x).argmax(dim=-1).to(INT_DTYPE)
