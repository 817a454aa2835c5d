"""Import all architecture configs for their ``@register`` side effects:
the reference's ten."""
from repro_torch.configs.archs import (  # noqa: F401
    deepseek_67b,
    mamba2_1_3b,
    minicpm3_4b,
    mistral_large_123b,
    qwen1_5_32b,
    qwen2_vl_7b,
    qwen3_moe_30b_a3b,
    qwen3_moe_235b_a22b,
    seamless_m4t_medium,
    zamba2_2_7b,
)
