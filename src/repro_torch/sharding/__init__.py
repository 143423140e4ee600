"""Sharding for the port, as `repro/sharding`: the activation policy
(`api`) and the Monte-Carlo solver's partition specs (`partition`)."""
from repro_torch.sharding.api import (  # noqa: F401
    ShardingPolicy, clear_policy, current_policy, get_meta, policy_scope,
    set_policy, shard)
