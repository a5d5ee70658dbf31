from repro_torch.parallel.sharding import ShardingRules

__all__ = ["ShardingRules"]
