"""Import the architecture configs the port serves, for their
``@register`` side effects.  Other arches come with their slices."""
from repro_torch.configs.archs import qwen2_vl_7b  # noqa: F401
