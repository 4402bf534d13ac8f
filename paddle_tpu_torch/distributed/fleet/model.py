"""distributed_model: pick the meta-parallel wrapper (counterpart of
``paddle_tpu/distributed/fleet/model.py:15-36``; reference
fleet/model.py:32): under sharding > 1 at stage 3 the parameters are
first sliced (ZeRO-3, ``shard_parameters_fsdp``); then PipelineParallel
when pp > 1 (the model must be a ``PipelineLayer``), else
SegmentParallel when sep > 1 (the sequence split over sep; it also
serves mp), TensorParallel when mp > 1, ShardingParallel when sharding >
1, DataParallel otherwise. A pipeline over a sep mesh
(``PipelineParallel``), and ZeRO-3 with sep, raise."""
from __future__ import annotations

from .. import mesh as mesh_mod
from .meta_parallel import (DataParallel, SegmentParallel, ShardingParallel,
                            TensorParallel, shard_parameters_fsdp)


def distributed_model(model):
    from . import get_strategy
    strategy = get_strategy()
    stage = int(strategy.sharding_configs.get("stage", 1)) \
        if strategy is not None else 1
    sep = mesh_mod.axis_degree("sep") > 1
    if mesh_mod.axis_degree("sharding") > 1 and stage >= 3:
        if sep:
            raise NotImplementedError(
                "ZeRO-3 with sequence parallelism over sep: use sharding "
                "stage 1 or 2 with sep > 1")
        shard_parameters_fsdp(model, axis="sharding")
    hcg = mesh_mod.get_hybrid_communicate_group()
    if mesh_mod.axis_degree("pp") > 1:
        from .meta_parallel.pipeline_parallel import PipelineParallel
        return PipelineParallel(model, hcg, strategy=strategy)
    if sep:
        return SegmentParallel(model, hcg, strategy=strategy)
    if mesh_mod.axis_degree("mp") > 1:
        return TensorParallel(model, hcg, strategy=strategy)
    if mesh_mod.axis_degree("sharding") > 1:
        return ShardingParallel(model, hcg, strategy=strategy)
    comm = 25 if strategy is None else strategy.fuse_grad_size_in_MB
    return DataParallel(model, strategy=strategy, comm_buffer_size=comm)
