"""repro_torch.parallel — logical-axis sharding rules, the mesh context and
placement by spec (the port of ``repro.parallel``), and the model axis's
split by hand (``tensor``, the port's own)."""
from repro_torch.parallel.params import (cache_specs_for, param_specs_for,
                                         rules_for)
from repro_torch.parallel.sharding import (AxisInfo, NamedSharding,
                                           PartitionSpec, ShardedTensor,
                                           ShardingRules, current_rules,
                                           default_rules, param_specs, place,
                                           pshard, spec_for, use_sharding)

__all__ = ["ShardingRules", "default_rules", "pshard", "use_sharding",
           "param_specs", "spec_for", "current_rules", "AxisInfo",
           "PartitionSpec", "NamedSharding", "ShardedTensor", "place",
           "rules_for", "param_specs_for", "cache_specs_for"]
