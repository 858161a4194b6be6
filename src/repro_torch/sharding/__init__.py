from .ctx import ShardingCtx, current, shard_hint, use_sharding
from .layout import (axes_groups, axes_index, axes_size, batch_mean, full_shape, gather_shard,
                     local_cache, local_shard)
from .specs import (Spec, activation_rules, batch_specs, cache_specs, dp_axes, mesh_shape,
                    opt_state_specs, param_specs, to_placements)

__all__ = ["ShardingCtx", "shard_hint", "use_sharding", "current", "axes_size",
           "axes_index", "axes_groups", "local_cache", "local_shard", "gather_shard",
           "full_shape", "batch_mean", "Spec", "activation_rules", "batch_specs", "cache_specs",
           "dp_axes", "mesh_shape", "opt_state_specs", "param_specs", "to_placements"]
