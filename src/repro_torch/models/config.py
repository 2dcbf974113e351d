"""Static model configuration covering every assigned architecture family
(port of ``repro.models.config``; ``dtype`` is a torch dtype)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # True → experts sharded over the model axis (EP, OLMoE: 64/16 = 4/chip);
    # False → every expert TP-sharded on its ffn dim (Mixtral: 16384/16).
    expert_parallel: bool = True
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture.  Layer layout is ``scan_unit × scan_repeats
    + tail``: the parameters of each unit are stacked on a leading dim, as
    the JAX package stacks them for ``lax.scan``, and run unit by unit."""

    name: str
    family: str                     # dense | ssm | hybrid | moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads
    qk_norm: bool = False
    mlp_type: str = "swiglu"        # swiglu | gelu
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False

    # attention variants
    sliding_window: int | None = None   # SWA width (h2o-danube, mixtral)
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE (t,h,w)
    # decode-cache KV duplication factor: stored KV heads = num_kv_heads ×
    # kv_repeat, chosen so the cache shards align with query-head shards on
    # the 16-wide model axis (Megatron KV duplication; DESIGN.md §5)
    kv_repeat: int = 1

    # recurrent families
    rwkv_head_dim: int = 64             # rwkv6
    lru_width: int = 0                  # rg-lru hidden width (recurrentgemma)
    local_attn_window: int = 2048       # recurrentgemma local attention
    scan_unit: tuple[str, ...] = ("attn",)   # layer kinds per scan step
    tail: tuple[str, ...] = ()               # unrolled remainder layers

    # encoder-decoder (whisper): encoder length is the stub frontend's output
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # vlm/audio stub frontend: inputs are precomputed embeddings, not ids
    embeds_input: bool = False

    # MoE
    moe: MoESpec | None = None

    # numerics / paper technique
    dtype: Any = torch.bfloat16
    int8_matmul: bool = False       # NITRO int8 numerics on MLP/proj matmuls
    les_groups: int = 0             # >0: LES local-loss groups (paper algo)
    # cast fp32 master params to compute dtype ONCE at step entry: the FSDP
    # weight all-gathers and data-axis gradient reductions then move bf16
    # (half the wire bytes) instead of f32 (§Perf hillclimb lever)
    cast_params_once: bool = False
    # constrain the MoE dispatch buffer / expert activations to the expert
    # sharding inside the auto region — keeps EP expert compute local to its
    # model-shard instead of all-reducing the whole buffer (§Perf lever)
    moe_shard_buffers: bool = False

    # training
    remat: bool = True
    learning_rate: float = 3e-4
    weight_decay: float = 0.1

    # per-arch logical→mesh rule tweaks (e.g. TP-MoE vs EP-MoE)
    rule_overrides: tuple[tuple[str, str | tuple | None], ...] = ()
    # small models (rwkv6-3b): no TP — train batch shards over data×model,
    # params FSDP over both axes; serve keeps the default batch rules
    dp_only: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def scan_repeats(self) -> int:
        unit = max(len(self.scan_unit), 1)
        return (self.num_layers - len(self.tail)) // unit

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + stacked layers)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        kinds = list(self.scan_unit) * self.scan_repeats + list(self.tail)
        hd = self.head_dim
        for kind in kinds:
            if kind in ("attn", "local_attn"):
                total += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                total += self.num_heads * hd * d
                total += self._mlp_params()
            elif kind == "rec":
                w = self.lru_width or d
                total += 2 * d * w + w * d + 3 * w + 2 * w * w // 8  # gates
                total += self._mlp_params()
            elif kind == "rwkv":
                total += 5 * d * d + d * 64 * 2 + 2 * d  # mixing + decay lora
                total += d * self.d_ff + self.d_ff * d   # channel mix
        if self.encoder_layers:
            total += self.encoder_layers * (
                4 * d * hd * self.num_heads + 2 * d * self.d_ff
            )
            # decoder cross-attention
            total += (self.num_layers) * 4 * d * hd * self.num_heads
        return total

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            e, f = self.moe.num_experts, self.moe.d_ff_expert
            n_mat = 3 if self.mlp_type == "swiglu" else 2
            return e * n_mat * d * f + d * e
        n_mat = 3 if self.mlp_type == "swiglu" else 2
        return n_mat * d * self.d_ff

    def active_param_count(self) -> int:
        """Active params per token (= total for dense; top-k slice for MoE)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e, k = self.moe.num_experts, self.moe.top_k
        n_mat = 3 if self.mlp_type == "swiglu" else 2
        expert_mats = self.num_layers * e * n_mat * self.d_model * self.moe.d_ff_expert
        active_mats = expert_mats * k // e
        return full - expert_mats + active_mats
