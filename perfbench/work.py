"""The work NITRO-D's functions need, counted from shapes alone, and the
card's data-sheet peaks.

Counts are of the algorithm, whatever implements it: 2 operations per
multiply-add of each integer product; every input read once and every
output written once, at the dtypes of the NITRO-D function: in training,
int32 weights, δ, z* and activations; in serving, int32 images, the
weights at the width ``freeze`` narrows them to (the serving cell's
weights span the int16 range, so its plan takes the int32-operand route),
and int8 activations after the first layer.  A change of storage or digit
count in the program does not move these numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

#: NVIDIA H100 SXM data sheet: dense int8 tensor-core rate, HBM3 bandwidth.
PEAK_OPS = 1979e12
PEAK_BYTES = 3.35e12


class Layer(NamedTuple):
    kind: str        # 'conv' | 'linear' | 'output'
    h: int           # input height and width (1 for linear layers)
    w: int
    c: int           # input channels / features
    f: int           # output channels / features
    k: int           # kernel size (1 for linear layers)
    pool: bool
    lr_features: int  # the block's learning-layer input width (0: output)


def layers(blocks, input_shape, num_classes: int) -> list[Layer]:
    """Each block's forward layer, then the output layer.  ``blocks`` are
    dicts with ``kind``, ``out``, ``pool``, ``d_lr`` and ``k``."""
    out, shape = [], tuple(input_shape)
    for b in blocks:
        if b["kind"] == "conv":
            h, w, c = shape
            oh, ow = (h // 2, w // 2) if b["pool"] else (h, w)
            s = min(max(math.isqrt(max(b["d_lr"] // b["out"], 1)), 1), oh, ow)
            out.append(Layer("conv", h, w, c, b["out"], b["k"], b["pool"], s * s * b["out"]))
            shape = (oh, ow, b["out"])
        else:
            m = math.prod(shape)
            out.append(Layer("linear", 1, 1, m, b["out"], 1, False, b["out"]))
            shape = (b["out"],)
    out.append(Layer("output", 1, 1, math.prod(shape), num_classes, 1, False, 0))
    return out


def macs(layer: Layer) -> int:
    """Multiply-adds of one image through the layer's forward product."""
    return layer.h * layer.w * layer.k * layer.k * layer.c * layer.f


def forward_macs(net_layers) -> int:
    """Multiply-adds of one image through every forward and output layer."""
    return sum(macs(l) for l in net_layers)


def train_ops(net_layers, num_classes: int) -> int:
    """Integer operations of one image's LES step: each forward layer's
    product and its weight gradient; each learning layer's product, weight
    gradient and input gradient (the δ its block learns from); the output
    layer's product and weight gradient.  No recomputation."""
    ops = 0
    for l in net_layers:
        if l.kind == "output":
            ops += 2 * 2 * macs(l)
        else:
            ops += 2 * 2 * macs(l) + 2 * 3 * l.lr_features * num_classes
    return ops


def infer_ops(net_layers) -> int:
    """Integer operations of one image through the frozen forward pass."""
    return 2 * forward_macs(net_layers)


def nitro_cell_work(config: dict, traffic: dict, scale: float, entry_work) -> dict:
    """A NITRO-D block net's counts from shapes: operations an image, and
    each entry point's (ops, bytes) a step (a rank's, under data
    parallelism) or a served batch, as ``entry_work(layers, batch)``
    counts its driver's entry points."""
    from perfbench import harness

    net_layers = layers(harness.blocks(config, scale), config["input_shape"],
                        config["num_classes"])
    batch = traffic["batch"] // int(traffic.get("ranks", 1))
    entries = entry_work(net_layers, batch)
    return {"train_ops_per_image": train_ops(net_layers, config["num_classes"]),
            "infer_ops_per_image": infer_ops(net_layers), "entries": entries}


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


def train_entry_work(net_layers, batch: int) -> dict:
    """(ops, bytes) of each launch of one ``fuse_opt`` LES step's forward
    and weight-update kernels, by entry point: the forward conv and
    matmul (x, W in; a, z* out), the conv and matmul grad_W with
    IntegerSGD in the flush (x, δ, z*, W in; W′ out), all int32."""
    out: dict[str, list] = {}
    for l in net_layers:
        if l.kind == "output":
            continue
        x_el = batch * l.h * l.w * l.c
        y_el = batch * l.h * l.w * l.f
        w_el = l.k * l.k * l.c * l.f
        ops = 2 * batch * macs(l)
        fwd, upd = (("stream_conv_fwd", "stream_conv_grad_w_opt") if l.kind == "conv"
                    else ("nitro_matmul_fwd", "nitro_matmul_grad_w_opt"))
        out.setdefault(fwd, []).append((ops, 4 * (x_el + w_el + 2 * y_el)))
        out.setdefault(upd, []).append((ops, 4 * (x_el + 2 * y_el + 2 * w_el)))
    return out


def infer_entry_work(net_layers, batch: int, weight_bytes) -> dict:
    """(ops, bytes) of each launch of one serving batch through the plan:
    the first layer reads int32 images, every later one int8 activations;
    each layer's weights at ``weight_bytes`` (one width a layer, as the
    frozen model stores them); each layer writes int8 activations (pooled
    where the layer pools), the output layer int32 logits."""
    out: dict[str, list] = {}
    in_size = 4
    for l, w_size in zip(net_layers, weight_bytes, strict=True):
        x_el = batch * l.h * l.w * l.c
        w_el = l.k * l.k * l.c * l.f
        if l.kind == "conv":
            y_el = batch * (l.h // 2) * (l.w // 2) * l.f if l.pool else batch * l.h * l.w * l.f
            name, out_size = "stream_conv", 1
        else:
            y_el = batch * l.f
            name, out_size = "nitro_matmul", (4 if l.kind == "output" else 1)
        out.setdefault(name, []).append(
            (2 * batch * macs(l), x_el * in_size + w_size * w_el + y_el * out_size))
        in_size = out_size
    return out
