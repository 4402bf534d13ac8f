"""distributed_optimizer: wrap the user's optimizer for hybrid
parallelism (counterpart of ``paddle_tpu/distributed/fleet/
optimizer.py``; reference fleet.py:1427): the ZeRO-1 / ZeRO-2 / ZeRO-3
sharding optimizer when the strategy's sharding stage is 1 / 2 / 3 and
the sharding degree is above 1, else ``HybridParallelOptimizer``."""
from __future__ import annotations

from .. import mesh as mesh_mod
from .meta_optimizers import (DygraphShardingOptimizer,
                              DygraphShardingOptimizerV2,
                              GroupShardedOptimizerStage3,
                              HybridParallelOptimizer)


def distributed_optimizer(optimizer, strategy=None):
    from . import get_strategy
    strategy = strategy or get_strategy()
    hcg = mesh_mod.get_hybrid_communicate_group()
    if mesh_mod.axis_degree("sharding") > 1 and strategy is not None:
        stage = int(strategy.sharding_configs.get("stage", 1))
        if stage >= 3:
            return GroupShardedOptimizerStage3(optimizer, hcg, strategy)
        if stage == 2:
            return DygraphShardingOptimizerV2(optimizer, hcg, strategy)
        if stage == 1:
            return DygraphShardingOptimizer(optimizer, hcg, strategy)
    return HybridParallelOptimizer(optimizer, hcg, strategy)
