"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B family].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register
def qwen3_moe_235b_a22b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="qwen3-moe-235b-a22b-smoke", family="moe", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96,
            vocab_size=512,
            moe=MoEConfig(num_experts=8, top_k=2, num_groups=1,
                          capacity_factor=4.0),  # drop-free for smoke tests
        )
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
        num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536,
        vocab_size=151936, moe=MoEConfig(num_experts=128, top_k=8),
    )
