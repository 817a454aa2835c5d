"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, M-RoPE.
The vision frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings merged at the leading positions (dynamic-resolution ViT omitted).
"""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen2_vl_7b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="qwen2-vl-7b-smoke", family="vlm", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
            mrope=True, mrope_sections=(2, 3, 3), num_frontend_tokens=8,
            rope_theta=1e6,
        )
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
        num_heads=28, num_kv_heads=4, head_dim=128, d_ff=18944,
        vocab_size=152064, mrope=True, mrope_sections=(16, 24, 24),
        num_frontend_tokens=256, rope_theta=1e6,
    )
