"""paddle.incubate.nn (counterpart of ``paddle_tpu/incubate/nn``): the
fused and decode functionals and the fused layers."""
from . import functional
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd,
                    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
                    FusedMultiTransformer, FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm",
           "FusedDropoutAdd", "FusedFeedForward", "FusedLinear",
           "FusedMultiHeadAttention", "FusedMultiTransformer",
           "FusedTransformerEncoderLayer"]
