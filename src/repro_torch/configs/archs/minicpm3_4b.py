"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448, Multi-head Latent Attention
(q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v=64).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, register


@register
def minicpm3_4b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="minicpm3-4b-smoke", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
            mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                          qk_rope_head_dim=8, v_head_dim=8),
            tie_embeddings=True,
        )
    return ModelConfig(
        name="minicpm3-4b", family="dense", num_layers=62, d_model=2560,
        num_heads=40, num_kv_heads=40, head_dim=64, d_ff=6400,
        vocab_size=73448,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                      qk_rope_head_dim=32, v_head_dim=64),
        tie_embeddings=True, rope_theta=1e4,
    )
