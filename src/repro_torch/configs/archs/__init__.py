"""Import the architecture configs the port serves, for their
``@register`` side effects.  Other arches come with their slices."""
from repro_torch.configs.archs import (deepseek_67b,  # noqa: F401
                                       mamba2_1_3b, qwen2_vl_7b,
                                       qwen3_moe_30b_a3b)
