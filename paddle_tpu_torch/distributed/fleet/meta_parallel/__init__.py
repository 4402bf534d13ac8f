from ..layers.mpu import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, get_rng_state_tracker,
)
from .meta_parallel_base import MetaParallelBase  # noqa: F401
from .parallel_wrappers import (  # noqa: F401
    DataParallel, SegmentParallel, ShardingParallel, TensorParallel,
    shard_parameters_fsdp,
)
from .pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SharedLayerDesc,
)
from .pipeline_parallel import PipelineParallel  # noqa: F401
