from . import dygraph_optimizer  # noqa: F401
from .dygraph_optimizer import (  # noqa: F401
    DygraphShardingOptimizer, DygraphShardingOptimizerV2,
    GroupShardedOptimizerStage3,
    HybridParallelGradScaler, HybridParallelOptimizer,
)
