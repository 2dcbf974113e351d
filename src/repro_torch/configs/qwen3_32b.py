"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,          # qwen3 uses explicit head_dim 128
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        mlp_type="swiglu",
        rope_theta=1_000_000.0,
        scan_unit=("attn",),
        kv_repeat=2,           # kv 8 → 16 stored heads (model-axis aligned)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        qk_norm=True,
        mlp_type="swiglu",
        scan_unit=("attn",),
        remat=False,
    )
