from . import mp_layers, mp_ops, random  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ColumnParallelLinearModule, ParallelCrossEntropy,
    RowParallelLinear, RowParallelLinearModule, VocabParallelEmbedding,
    VocabParallelEmbeddingModule,
)
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)
