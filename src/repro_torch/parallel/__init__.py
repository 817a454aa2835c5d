"""Multi-device layer of the port: logical-axis rules and placement
(:mod:`repro_torch.parallel.sharding`) and GPipe
(:mod:`repro_torch.parallel.pipeline`)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    AxisRules,
    axis_rules,
    current_rules,
    logical_to_pspec,
    shard,
    specs_for_tree,
)
