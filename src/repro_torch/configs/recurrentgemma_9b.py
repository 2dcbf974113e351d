"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427; unverified]

38 = 12 × (rec, rec, attn) + (rec, rec) tail.  lru_width = 4096, local
attention window 2048.  MQA KV (1 head) is stored 16×-duplicated so the
decode cache shards over the model axis (tiny anyway: window-sized).
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        mlp_type="swiglu",
        rope_theta=10_000.0,
        lru_width=4096,
        local_attn_window=2048,
        scan_unit=("rec", "rec", "attn"),
        tail=("rec", "rec"),
        kv_repeat=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        mlp_type="swiglu",
        lru_width=64,
        local_attn_window=16,
        scan_unit=("rec", "rec", "attn"),
        tail=("rec", "rec"),
        remat=False,
    )
