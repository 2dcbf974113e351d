"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, GeLU MLP.  [arXiv:2402.19173; hf]

36 heads do not divide the 16-wide model axis → attention activations are
replicated over ``model`` (Megatron fallback; MLP stays TP).  Recorded in
DESIGN.md §5 and visible in the roofline as redundant attention compute.
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        mlp_type="gelu",
        rope_theta=100_000.0,
        scan_unit=("attn",),
        kv_repeat=1,
        rule_overrides=(
            ("heads", None), ("kv_heads", None),
            ("p_heads", None), ("p_kv_heads", None),
            ("kv_cache_heads", None),
            ("kv_seq", "model"),   # serve: shard the 32k cache on seq instead
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=72,
        num_heads=6,          # preserves the non-power-of-two head count
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mlp_type="gelu",
        scan_unit=("attn",),
        remat=False,
    )
