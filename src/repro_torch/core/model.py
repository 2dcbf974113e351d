"""NITRO-D model container (port of ``repro.core.model``).

A static ``NitroConfig`` plus a parameter tree of int32 tensors shaped
exactly like the JAX package's:
``{"blocks": [{"fw": {"w"}, "lr": {"w"}}, ...], "output": {"w"}}``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import blocks as B
from repro_torch.core import prng
from repro_torch.core.numerics import INT_DTYPE
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import trace


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


def init_params(key: torch.Tensor, cfg: NitroConfig, *,
                device=DEFAULT_DEVICE) -> dict:
    """Initialise every block + the output layers (integer Kaiming).

    ``key`` splits into one key per block and one for the output layers,
    as in the JAX package, so ``init_params(prng.PRNGKey(s), cfg)`` equals
    its ``init_params(jax.random.PRNGKey(s), cfg)`` bit for bit.
    """
    device = resolve_device(device)
    keys = prng.split(key, cfg.num_blocks + 1)
    params: dict = {"blocks": [], "output": None}
    shape = cfg.input_shape
    for spec, k in zip(cfg.blocks, keys[:-1]):
        p, shape = B.init_block(k, spec, shape, cfg.num_classes, device=device)
        params["blocks"].append(p)
    feat = 1
    for d in shape:
        feat *= d
    params["output"] = B.init_output(keys[-1], feat, cfg.num_classes,
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


def forward(
    params: dict,
    cfg: NitroConfig,
    x,
    *,
    train: bool = False,
    key: torch.Tensor | None = None,
    fused: bool = True,
    backend: str = "auto",
    conv_mode: str = "stream",
    dp_axis=None,
    dp_shards: int = 1,
) -> tuple[torch.Tensor, list[torch.Tensor], list[dict], dict]:
    """Full forward pass: (ŷ, block activations, forward caches, output
    cache).  Training splits ``key`` into one dropout key per block.
    ``dp_axis``/``dp_shards`` describe a data-parallel rank; they reach
    only dropout (global-batch mask, this rank's rows)."""
    device = params["output"]["w"].device
    a = torch.as_tensor(x).to(device=device, dtype=INT_DTYPE)
    acts: list[torch.Tensor] = []
    caches: list[dict] = []
    if train and key is not None:
        drop_keys = list(prng.split(key, cfg.num_blocks))
    else:
        drop_keys = [None] * cfg.num_blocks
    tracer = trace.active()
    for i, (spec, p, dk) in enumerate(zip(cfg.blocks, params["blocks"], drop_keys)):
        with tracer.span("blocks.forward", block=i, kind=spec.kind):
            a, cache = B.forward_layers(
                p, spec, a, dropout_key=dk, train=train, fused=fused,
                backend=backend, conv_mode=conv_mode, dp_axis=dp_axis,
                dp_shards=dp_shards,
            )
        acts.append(a)
        caches.append(cache)
    y_hat, out_cache = B.output_forward(params["output"], a)
    return y_hat, acts, caches, out_cache


def frozen_forward(params: dict, cfg: NitroConfig, x) -> torch.Tensor:
    """Inference logits on frozen params: the unfused reference composition.

    The oracle the fused plan is held against — it calls no kernel.
    """
    y_hat, _, _, _ = forward(params, cfg, x, train=False, fused=False)
    return y_hat


def predict(params: dict, cfg: NitroConfig, x) -> torch.Tensor:
    """Predicted labels (int32, as the JAX package's argmax returns)."""
    return frozen_forward(params, cfg, x).argmax(dim=-1).to(INT_DTYPE)


def count_params(params) -> int:
    """Number of scalars in every tensor leaf of a parameter tree."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return 0 if params is None else int(params.numel())
