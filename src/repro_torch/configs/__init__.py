"""Architecture registry (port of ``repro.configs``): the paper's NITRO-D
architectures (``get_paper_config``) and the ten LM architectures,
``get_config(name)`` / ``get_smoke_config(name)``.

Each LM module exposes ``full_config()`` (the published numbers) and
``smoke_config()`` (a reduced same-family config for CPU runs), number for
number the JAX package's.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.paper import get as get_paper_config  # noqa: F401

ARCHS = {
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}

# the paper's own architectures (integer-only NITRO-D models)
PAPER_ARCHS = ("mlp1", "mlp2", "mlp3", "mlp4", "vgg8b", "vgg11b")


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).full_config()


def get_smoke_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).smoke_config()


def list_archs() -> list[str]:
    return sorted(ARCHS)
