"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention.

54 Mamba2 layers d_model=2560 ssm_state=64 + one shared attention+MLP block
(32H kv=32, d_ff=10240) invoked every 6 layers on concat(hidden, embedding)
with per-invocation LoRA deltas, vocab=32000.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig, register


@register
def zamba2_2_7b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="zamba2-2.7b-smoke", family="hybrid", num_layers=4, d_model=64,
            num_heads=4, num_kv_heads=4, head_dim=32, d_ff=0, vocab_size=512,
            ssm=SSMConfig(d_state=16, head_dim=16, chunk_size=32),
            hybrid=HybridConfig(shared_every=2, shared_num_heads=4,
                                shared_kv_heads=4, shared_d_ff=128, lora_rank=4),
            tie_embeddings=True,
        )
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
        num_heads=32, num_kv_heads=32, head_dim=160, d_ff=0, vocab_size=32000,
        ssm=SSMConfig(d_state=64, head_dim=64, chunk_size=256),
        hybrid=HybridConfig(shared_every=6, shared_num_heads=32,
                            shared_kv_heads=32, shared_d_ff=10240, lora_rank=8),
        tie_embeddings=True,
    )
