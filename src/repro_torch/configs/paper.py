"""The paper's architectures (Appendix C, Tables 4–5) with the
hyper-parameters of Appendix D (Tables 6–7) — a copy of
``repro.configs.paper`` over the port's ``BlockSpec``/``NitroConfig``.

``scale`` shrinks widths uniformly for CPU-sized runs; ``scale=1`` is the
paper's full width.
"""

from __future__ import annotations

from repro_torch.core.blocks import BlockSpec
from repro_torch.core.model import NitroConfig


def _s(x: int, scale: float) -> int:
    return max(int(round(x * scale)), 8)


def mlp(name: str, widths, input_dim: int, g: int, gamma: int, eta_fw: int,
        eta_lr: int, p_l: float, scale: float = 1.0) -> NitroConfig:
    blocks = tuple(
        BlockSpec("linear", _s(w, scale), dropout=p_l) for w in widths
    )
    return NitroConfig(
        blocks=blocks, input_shape=(input_dim,), num_classes=g,
        gamma_inv=gamma, eta_fw=eta_fw, eta_lr=eta_lr, name=name,
    )


def cnn(name: str, layout, input_shape, g: int, gamma: int, eta_fw: int,
        eta_lr: int, d_lr: int, p_c: float, p_l: float,
        scale: float = 1.0) -> NitroConfig:
    blocks = []
    for kind, width, pool in layout:
        if kind == "conv":
            blocks.append(
                BlockSpec("conv", _s(width, scale), pool=pool,
                          d_lr=_s(d_lr, scale), dropout=p_c)
            )
        else:
            blocks.append(BlockSpec("linear", _s(width, scale), dropout=p_l))
    return NitroConfig(
        blocks=tuple(blocks), input_shape=input_shape, num_classes=g,
        gamma_inv=gamma, eta_fw=eta_fw, eta_lr=eta_lr, name=name,
    )


# (kind, width, maxpool-after) — Table 5; pools follow the listed MaxPool2D
VGG8B_LAYOUT = [
    ("conv", 128, False), ("conv", 256, True),
    ("conv", 256, False), ("conv", 512, True),
    ("conv", 512, True), ("conv", 512, True),
    ("linear", 1024, False),
]
VGG11B_LAYOUT = [
    ("conv", 128, False), ("conv", 128, False), ("conv", 128, False),
    ("conv", 256, True), ("conv", 256, False), ("conv", 512, True),
    ("conv", 512, False), ("conv", 512, True), ("conv", 512, True),
    ("linear", 1024, False),
]


def get(name: str, scale: float = 1.0, input_shape=None) -> NitroConfig:
    """Paper configs with Appendix-D hyper-parameters."""
    if name == "mlp1":    # MNIST: 784→100→50→10, γ=512, η=(12000,3000)
        return mlp("mlp1", [100, 50], 784, 10, 512, 12000, 3000, 0.0, scale)
    if name == "mlp2":    # FashionMNIST: 784→200→100→50→10
        return mlp("mlp2", [200, 100, 50], 784, 10, 512, 10000, 8000, 0.0, scale)
    if name == "mlp3":    # 784→1024×3→10, γ=512, η=(28000,5000)
        return mlp("mlp3", [1024, 1024, 1024], 784, 10, 512, 28000, 5000, 0.0, scale)
    if name == "mlp4":    # CIFAR-10: 3072→3000×3→10, p_l=0.1
        return mlp("mlp4", [3000, 3000, 3000], 3072, 10, 512, 19000, 7500, 0.1, scale)
    if name == "vgg8b":
        shape = input_shape or (32, 32, 3)
        return cnn("vgg8b", VGG8B_LAYOUT, shape, 10, 512, 25000, 3000,
                   4096, 0.0, 0.1, scale)
    if name == "vgg11b":
        shape = input_shape or (32, 32, 3)
        return cnn("vgg11b", VGG11B_LAYOUT, shape, 10, 512, 28000, 4500,
                   4096, 0.0, 0.0, scale)
    raise KeyError(f"unknown paper arch {name!r}")
