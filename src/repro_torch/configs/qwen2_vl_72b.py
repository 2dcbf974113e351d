"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution; vision frontend STUBBED
(input_specs provides precomputed patch embeddings).
[arXiv:2409.12191; hf]"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        mlp_type="swiglu",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),   # (t, h, w) — sums to head_dim/2
        embeds_input=True,             # stub frontend: patch embeddings in
        scan_unit=("attn",),
        kv_repeat=2,
        # 72B bf16 weights (9 GiB/chip TP-only) + 8.6 GiB cache exceed HBM
        # at decode_32k: keep weights FSDP-sharded over data at serve too
        rule_overrides=(("p_fsdp", "data"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        mlp_type="swiglu",
        mrope_sections=(2, 3, 3),
        embeds_input=True,
        scan_unit=("attn",),
        remat=False,
    )
