"""distributed_model: pick the meta-parallel wrapper (counterpart of
``paddle_tpu/distributed/fleet/model.py:15-36``; reference
fleet/model.py:32): TensorParallel when mp > 1, else ShardingParallel
when sharding > 1, else DataParallel. Pipeline parallelism (pp > 1) and
ZeRO-3 (sharding stage 3) raise: they come with the pipeline slice."""
from __future__ import annotations

from .. import mesh as mesh_mod
from .meta_parallel import DataParallel, ShardingParallel, TensorParallel


def distributed_model(model):
    from . import get_strategy
    strategy = get_strategy()
    stage = int(strategy.sharding_configs.get("stage", 1)) \
        if strategy is not None else 1
    if mesh_mod.axis_degree("pp") > 1:
        raise NotImplementedError(
            "pipeline parallelism (pp_degree > 1) comes with the pipeline "
            "slice of the port (ROADMAP D2)")
    if mesh_mod.axis_degree("sharding") > 1 and stage >= 3:
        raise NotImplementedError(
            "ZeRO-3 (sharding stage 3) comes with the pipeline / ZeRO-3 "
            "slice of the port (ROADMAP D2)")
    hcg = mesh_mod.get_hybrid_communicate_group()
    if mesh_mod.axis_degree("mp") > 1:
        return TensorParallel(model, hcg, strategy=strategy)
    if mesh_mod.axis_degree("sharding") > 1:
        return ShardingParallel(model, hcg, strategy=strategy)
    comm = 25 if strategy is None else strategy.fuse_grad_size_in_MB
    return DataParallel(model, strategy=strategy, comm_buffer_size=comm)
