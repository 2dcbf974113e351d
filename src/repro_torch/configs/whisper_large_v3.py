"""whisper-large-v3 [audio]: 32L d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866 — encoder-decoder, conv frontend STUBBED (input_specs provides
precomputed 1500-frame embeddings).  [arXiv:2212.04356; unverified]

Backbone only per the assignment: 32 encoder + 32 decoder layers (the
published large-v3 layout), GeLU MLPs, MHA.  20 heads don't divide the
16-wide model axis → attention replicated over ``model`` (MLP stays TP);
the serve cache shards on the sequence dim instead (rule override).
RoPE substitutes whisper's learned/sinusoidal positions — backbone-shape
faithful, positional scheme adapted (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,            # decoder layers; +32 encoder below
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        mlp_type="gelu",
        rope_theta=10_000.0,
        scan_unit=("attn_cross",),  # decoder layers: self-attn + cross-attn
        encoder_layers=32,
        encoder_seq=1500,
        kv_repeat=1,
        rule_overrides=(
            ("heads", None), ("kv_heads", None),
            ("p_heads", None), ("p_kv_heads", None),
            ("kv_cache_heads", None),
            ("kv_seq", "model"),
            # vocab 51866 is not divisible by 16 → replicate the embedding
            ("p_vocab", None), ("vocab", None),
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        mlp_type="gelu",
        scan_unit=("attn_cross",),
        encoder_layers=2,
        encoder_seq=24,
        remat=False,
    )
