from .ctx import ShardingCtx, current, shard_hint, use_sharding
from .layout import axes_groups, axes_index, axes_size, local_cache

__all__ = ["ShardingCtx", "shard_hint", "use_sharding", "current", "axes_size",
           "axes_index", "axes_groups", "local_cache"]
