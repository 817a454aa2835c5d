"""Qwen1.5-32B [hf:Qwen/Qwen1.5-32B].

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen1_5_32b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="qwen1.5-32b-smoke", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
            qkv_bias=True,
        )
    return ModelConfig(
        name="qwen1.5-32b", family="dense", num_layers=64, d_model=5120,
        num_heads=40, num_kv_heads=40, head_dim=128, d_ff=27392,
        vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    )
