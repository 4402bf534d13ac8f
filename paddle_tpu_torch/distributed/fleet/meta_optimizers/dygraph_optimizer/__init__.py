from .hybrid_parallel_optimizer import (  # noqa: F401
    DygraphShardingOptimizer, DygraphShardingOptimizerV2,
    GroupShardedOptimizerStage3, FlatParams,
    HybridParallelGradScaler, HybridParallelOptimizer, clip_scale,
    hybrid_global_norm,
)
