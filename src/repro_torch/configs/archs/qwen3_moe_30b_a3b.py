"""Qwen3-MoE-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register
def qwen3_moe_30b_a3b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="qwen3-moe-30b-a3b-smoke", family="moe", num_layers=2,
            d_model=48, num_heads=4, num_kv_heads=2, head_dim=12, d_ff=64,
            vocab_size=384,
            moe=MoEConfig(num_experts=4, top_k=2, num_groups=1,
                          capacity_factor=4.0),  # drop-free for smoke tests
        )
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=4, head_dim=128, d_ff=768,
        vocab_size=151936, moe=MoEConfig(num_experts=128, top_k=8),
    )
