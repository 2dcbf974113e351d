"""LM-family model zoo (port of ``repro.models``): dense/GQA/SWA
transformers, RWKV6, RG-LRU hybrid, MoE, encoder-decoder, VLM backbone,
with the NITRO-D hooks (LES local-loss groups, NITRO int8 matmul
numerics).  The training half; serving (prefill, decode, caches) is not
ported yet."""

from repro_torch.models.config import ModelConfig, MoESpec

__all__ = ["ModelConfig", "MoESpec"]
