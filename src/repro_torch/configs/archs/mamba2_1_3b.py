"""Mamba2-1.3B [arXiv:2405.21060; unverified] — SSD (state-space duality).

48L d_model=2048, attention-free, ssm_state=128, vocab=50280.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register
def mamba2_1_3b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="mamba2-1.3b-smoke", family="ssm", num_layers=2, d_model=64,
            num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=512,
            ssm=SSMConfig(d_state=16, head_dim=16, chunk_size=32),
            tie_embeddings=True,
        )
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
        num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, chunk_size=256),
        tie_embeddings=True,
    )
