"""Input-shape cells: every (architecture × shape) pair the dry run covers
(port of ``repro.launch.shapes``).

LM shapes are seq_len × global_batch:

    train_4k     seq=4096    gb=256   → train_step
    prefill_32k  seq=32768   gb=32    → prefill (serve)
    decode_32k   seq=32768   gb=128   → decode_step (1 new token, 32k cache)
    long_500k    seq=524288  gb=1     → decode_step (sub-quadratic archs only)

``long_500k`` runs only for SSM / hybrid / SWA architectures; a 512k
dense-attention KV decode is quadratic by construction.

The specs are tensors on the ``meta`` device, the port's
``ShapeDtypeStruct``: the shapes and dtypes of JAX's, no storage.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import dry_run
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# archs with a sub-quadratic path (SSM state / RG-LRU / SWA ring cache)
LONG_CONTEXT_OK = {
    "rwkv6-3b",            # O(1) recurrent state
    "recurrentgemma-9b",   # RG-LRU + 2048-window local attention
    "h2o-danube-1.8b",     # SWA 4096 ring cache
    "mixtral-8x22b",       # SWA 4096 ring cache
}


@dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str
    seq: int
    batch: int
    applicable: bool
    skip_reason: str = ""


def cell(cfg: ModelConfig, shape_name: str) -> Cell:
    s = SHAPES[shape_name]
    applicable, reason = True, ""
    if shape_name == "long_500k" and cfg.name.split("-smoke")[0] not in LONG_CONTEXT_OK:
        applicable = False
        reason = ("pure full-attention arch: 512k dense KV decode is quadratic "
                  "by construction (DESIGN.md §4 skip list)")
    return Cell(arch=cfg.name, shape=shape_name, kind=s["kind"], seq=s["seq"],
                batch=s["batch"], applicable=applicable, skip_reason=reason)


def all_cells(cfg: ModelConfig) -> list[Cell]:
    return [cell(cfg, s) for s in SHAPES]


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Meta tensors for one training batch."""
    specs = {"labels": _sds((batch, seq), torch.int32)}
    if cfg.embeds_input:
        specs["embeds"] = _sds((batch, seq, cfg.d_model), torch.bfloat16)
        if cfg.mrope_sections is not None:
            specs["positions"] = _sds((3, batch, seq), torch.int32)
    else:
        specs["tokens"] = _sds((batch, seq), torch.int32)
    if cfg.encoder_layers:
        specs["enc_embeds"] = _sds((batch, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return specs


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    specs = dict(train_batch_specs(cfg, batch, seq))
    del specs["labels"]
    return specs


def decode_token_specs(batch: int) -> torch.Tensor:
    return _sds((batch,), torch.int32)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int):
    """The cache tree on the ``meta`` device (no allocation)."""
    from repro_torch.models import transformer as T

    with dry_run():
        return T.init_cache(cfg, batch, max_seq, device="meta")


def enc_out_specs(cfg: ModelConfig, batch: int):
    if not cfg.encoder_layers:
        return None
    return _sds((batch, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
