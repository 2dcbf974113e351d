"""Integer local-loss blocks (port of ``repro.core.blocks``, forward).

A block's forward layers are IntegerConv2D/IntegerLinear → NITRO
Scaling → NITRO-ReLU → [MaxPool2D]; its learning layers (adaptive
avg-pool → flatten → IntegerLinear(→ G)) are initialised so the
parameter tree matches the JAX package's one-to-one, but only training
runs them.  This slice ports the unfused inference forward — the oracle
the fused plan is held against.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import activations, layers, scaling


@dataclass(frozen=True)
class BlockSpec:
    """Static description of one integer local-loss block."""

    kind: str                 # 'conv' | 'linear'
    out_features: int         # conv filters or linear width
    pool: bool = False        # MaxPool2D(2,2) after the activation
    dropout: float = 0.0      # p_c / p_l (training only)
    d_lr: int = 4096          # learning-layer input feature budget (conv)
    alpha_inv: int = activations.DEFAULT_ALPHA_INV
    kernel_size: int = 3


def init_block(
    generator: torch.Generator,
    spec: BlockSpec,
    in_shape: tuple[int, ...],
    num_classes: int,
    *,
    device="cpu",
) -> tuple[dict, tuple[int, ...]]:
    """Init one block's params; returns (params, output shape w/o batch).

    Forward weights are drawn before the learning-layer weights.
    """
    if spec.kind == "conv":
        h, w, c = in_shape
        fw = layers.conv_init(generator, c, spec.out_features,
                              spec.kernel_size, device=device)
        oh, ow = (h // 2, w // 2) if spec.pool else (h, w)
        out_shape = (oh, ow, spec.out_features)
        s, _ = layers.avgpool_grid(oh, ow, spec.out_features, spec.d_lr)
        lr_in = s * s * spec.out_features
    elif spec.kind == "linear":
        m = 1
        for d in in_shape:  # linear blocks flatten whatever precedes them
            m *= d
        fw = layers.linear_init(generator, m, spec.out_features, device=device)
        out_shape = (spec.out_features,)
        lr_in = spec.out_features
    else:
        raise ValueError(f"unknown block kind {spec.kind!r}")
    lr = layers.linear_init(generator, lr_in, num_classes, device=device)
    return {"fw": fw, "lr": lr}, out_shape


def forward_layers(params: dict, spec: BlockSpec, x: torch.Tensor) -> torch.Tensor:
    """A block's forward layers at inference (unfused, no dropout)."""
    if spec.kind == "conv":
        sf = scaling.conv_scale_factor(spec.kernel_size, x.shape[-1])
        z = layers.conv_forward(params["fw"], x)
    else:
        if x.ndim > 2:  # flatten conv activations entering a linear block
            x = layers.flatten_forward(x)
        sf = scaling.linear_scale_factor(x.shape[-1])
        z = layers.linear_forward(params["fw"], x)
    a = activations.nitro_relu(scaling.scale_forward(z, sf), spec.alpha_inv)
    if spec.pool:
        a = layers.maxpool_forward(a)
    return a


def init_output(generator: torch.Generator, in_features: int,
                num_classes: int, *, device="cpu") -> dict:
    return layers.linear_init(generator, in_features, num_classes, device=device)


def output_forward(params: dict, a: torch.Tensor) -> torch.Tensor:
    """Output layers: flatten → IntegerLinear → NITRO Scaling (no ReLU)."""
    if a.ndim > 2:
        a = layers.flatten_forward(a)
    z = layers.linear_forward(params, a)
    return scaling.scale_forward(z, scaling.linear_scale_factor(a.shape[-1]))
