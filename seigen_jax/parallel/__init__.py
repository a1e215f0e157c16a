from .partition import Plan, make_plan, morton_order
from .dist_ops import (
    make_sharded_run,
    run_distributed,
    shard_params,
    shard_receivers,
    shard_sources,
    shard_state,
    unshard_field,
)

__all__ = [
    "Plan",
    "make_plan",
    "morton_order",
    "make_sharded_run",
    "run_distributed",
    "shard_params",
    "shard_receivers",
    "shard_sources",
    "shard_state",
    "unshard_field",
]
