"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; hf]"""

from repro_torch.models.config import ModelConfig

SWA_WINDOW = 4096


def full_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        mlp_type="swiglu",
        rope_theta=10_000.0,
        sliding_window=SWA_WINDOW,
        scan_unit=("attn",),
        kv_repeat=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mlp_type="swiglu",
        sliding_window=16,
        scan_unit=("attn",),
        remat=False,
    )
