"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf]

d_ff=1024 is the *per-expert* width.  64 experts shard over the model axis
(expert parallelism, 4 experts/chip at TP16).
"""

from repro_torch.models.config import ModelConfig, MoESpec


def full_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        qk_norm=True,          # olmoe uses qk-norm
        mlp_type="swiglu",
        rope_theta=10_000.0,
        scan_unit=("attn",),
        moe=MoESpec(num_experts=64, top_k=8, d_ff_expert=1024, expert_parallel=True),
        kv_repeat=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=64,
        vocab_size=256,
        qk_norm=True,
        mlp_type="swiglu",
        scan_unit=("attn",),
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=64, expert_parallel=True),
        remat=False,
    )
