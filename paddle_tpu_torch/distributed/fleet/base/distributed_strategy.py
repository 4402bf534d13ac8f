"""DistributedStrategy, the training-strategy configuration (counterpart
of ``paddle_tpu/distributed/fleet/base/distributed_strategy.py``;
reference distributed_strategy.py:284, backed by
distributed_strategy.proto, HybridConfig :106).

Its hard job is the topology: ``hybrid_configs``' degrees shape the
rank mesh ``fleet.init`` builds. ``sharding_configs["stage"]`` picks the
sharded optimizer (1: ZeRO-1, 2: ZeRO-2); ``fuse_grad_size_in_MB`` is
the bucket size of the gradient all-reduce; ``amp_configs``,
``recompute_configs`` and the other knobs are kept as configuration for
scripts that set them, read by nothing else in the port.
"""
from __future__ import annotations

from typing import Any, Dict


_HYBRID_DEFAULTS = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "ep_degree": 1,
    "order": ["pp", "dp", "sharding", "sep", "mp"],
}


class DistributedStrategy:
    def __init__(self):
        self._hybrid_configs: Dict[str, Any] = dict(_HYBRID_DEFAULTS)
        self.sharding_configs: Dict[str, Any] = {
            "stage": 1, "degree": 1, "split_param": False,
            "tensor_fusion": False, "accumulate_steps": 1,
            "comm_overlap": False, "comm_buffer_size_MB": 256,
        }
        self.amp = False
        self.amp_configs: Dict[str, Any] = {
            "init_loss_scaling": 32768.0, "use_dynamic_loss_scaling": True,
            "incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2,
            "incr_ratio": 2.0, "decr_ratio": 0.5,
            "custom_white_list": [], "custom_black_list": [],
            "use_pure_fp16": False, "use_fp16_guard": False,
            "use_bf16": True,
        }
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {"checkpoints": []}
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {
            "accumulate_steps": 1, "micro_batch_size": 1,
            "schedule_mode": "1F1B",
        }
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.a_sync = False
        self.a_sync_configs: Dict[str, Any] = {}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.without_graph_optimization = True

    @property
    def hybrid_configs(self) -> Dict[str, Any]:
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs: Dict[str, Any]):
        merged = dict(_HYBRID_DEFAULTS)
        merged.update(self._hybrid_configs)
        merged.update(configs or {})
        self._hybrid_configs = merged

    def hybrid_degrees(self) -> Dict[str, int]:
        """Mesh degrees keyed by axis name ('mp' is the tensor axis)."""
        c = self._hybrid_configs
        return {
            "pp": int(c.get("pp_degree", 1)),
            "dp": int(c.get("dp_degree", 1)),
            "sharding": int(c.get("sharding_degree",
                                  self.sharding_configs.get("degree", 1))),
            "sep": int(c.get("sep_degree", 1)),
            "mp": int(c.get("mp_degree", 1)),
            # expert parallelism: an "ep" axis innermost, only when asked
            # for (the JAX package's fleet builds none; its MoE reads an
            # "ep" axis of a mesh built by hand)
            **({"ep": int(c["ep_degree"])}
               if int(c.get("ep_degree", 1)) > 1 else {}),
        }

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self._hybrid_configs})"
