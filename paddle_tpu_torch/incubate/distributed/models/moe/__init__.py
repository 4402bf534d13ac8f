"""Mixture of experts (counterpart of
``paddle_tpu/incubate/distributed/models/moe``): the gates and
``MoELayer``, whose default dispatch runs the grouped-FFN kernels."""
from .gate import (BaseGate, GShardGate, NaiveGate, SwitchGate, topk_gating,
                   topk_gating_sparse)
from .moe_layer import GroupedExpertsFFN, MoELayer

__all__ = ["BaseGate", "GShardGate", "NaiveGate", "SwitchGate", "topk_gating",
           "topk_gating_sparse", "GroupedExpertsFFN", "MoELayer"]
