"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— Finch, data-dependent decay.  [arXiv:2404.05892; hf]

3B params → pure data parallelism over the whole 256-chip pod is the right
strategy (DESIGN.md §5): batch shards over (data × model), parameters are
fully FSDP-sharded over both axes.  The 40 RWKV heads (head_dim 64) need
no TP.
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=40,          # d_model / rwkv_head_dim
        num_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        rwkv_head_dim=64,
        scan_unit=("rwkv",),
        dp_only=True,
        rule_overrides=(
            ("heads", None), ("kv_heads", None), ("rnn", None), ("mlp", None),
            ("p_heads", None), ("p_kv_heads", None), ("p_mlp", None),
            ("p_rnn", None), ("p_vocab", None), ("vocab", None),
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        rwkv_head_dim=16,
        scan_unit=("rwkv",),
        remat=False,
    )
