"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def mistral_large_123b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="mistral-large-123b-smoke", family="dense", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=512,
        )
    return ModelConfig(
        name="mistral-large-123b", family="dense", num_layers=88,
        d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
        d_ff=28672, vocab_size=32768, rope_theta=1e6,
    )
