"""SeamlessM4T-medium backbone [arXiv:2308.11596; hf].

Encoder-decoder, 12L enc + 12L dec, d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=256206.  The audio (conformer speech-encoder) frontend is a STUB:
``input_specs`` provides precomputed frame embeddings for the encoder.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def seamless_m4t_medium(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="seamless-m4t-medium-smoke", family="encdec", num_layers=2,
            enc_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
            d_ff=128, vocab_size=512, num_frontend_tokens=16, causal=True,
        )
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec", num_layers=12,
        enc_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=4096, vocab_size=256206, num_frontend_tokens=0,
    )
