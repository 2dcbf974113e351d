"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        mlp_type="swiglu",
        rope_theta=500_000.0,
        tie_embeddings=True,   # llama3.2-1b ties in/out embeddings
        scan_unit=("attn",),
        kv_repeat=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mlp_type="swiglu",
        tie_embeddings=True,
        scan_unit=("attn",),
        remat=False,
    )
