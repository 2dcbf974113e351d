"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA.  [arXiv:2401.04088; hf]

8 wide experts < 16 TP ranks → each expert is tensor-parallel on its ffn
dim instead of expert-parallel (rule override).
"""

from repro_torch.models.config import ModelConfig, MoESpec

SWA_WINDOW = 4096


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        mlp_type="swiglu",
        rope_theta=1_000_000.0,
        sliding_window=SWA_WINDOW,
        scan_unit=("attn",),
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=16384, expert_parallel=False),
        kv_repeat=2,
        rule_overrides=(
            ("expert", None), ("p_expert", None),
            ("mlp_expert", "model"), ("p_mlp_expert", "model"),
            # 141B params exceed TP-only serving HBM (17.6 GiB/chip bf16):
            # keep weights FSDP-sharded over data at serve too
            ("p_fsdp", "data"),
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mlp_type="swiglu",
        sliding_window=16,
        scan_unit=("attn",),
        moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=128, expert_parallel=False),
        remat=False,
    )
