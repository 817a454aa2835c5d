"""DeepSeek-67B [arXiv:2401.02954; hf] — llama-arch dense decoder.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.  The full
width (~67B parameters, ~134 GB in bf16) does not fit one 80 GB card; the
smoke config is the router tests' model.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_67b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="deepseek-67b-smoke", family="dense", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=512,
        )
    return ModelConfig(
        name="deepseek-67b", family="dense", num_layers=95, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22016,
        vocab_size=102400, rope_theta=1e4,
    )
