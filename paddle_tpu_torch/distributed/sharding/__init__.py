"""``paddle.distributed.sharding``, the group-sharded (ZeRO) dygraph API
(counterpart of ``paddle_tpu/distributed/sharding/__init__.py``).

``group_sharded_parallel(model, optimizer, level)``: level "os" wraps the
optimizer in the ZeRO-1 ``DygraphShardingOptimizer``, "os_g" in the
ZeRO-2 ``DygraphShardingOptimizerV2`` (and ``DistributedTrainStep``
reads the stage from it); the model is broadcast over the data group.
"p_g_os" (ZeRO-3) slices a torch module's parameters over the data group
(``shard_parameters_fsdp``: gathered layer by layer in the forward and
the backward, gradients reduce-scattered) and wraps the optimizer in
``GroupShardedOptimizerStage3``; ``DistributedTrainStep`` then runs stage
3 and an eager ``loss.backward(); opt.step()`` works as well."""
from __future__ import annotations

import os

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def group_sharded_parallel(model, optimizer, level, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError("level must be one of os / os_g / p_g_os")
    if offload:
        raise NotImplementedError("optimizer-state offload is not ported")
    from ..fleet.meta_optimizers import (DygraphShardingOptimizer,
                                         DygraphShardingOptimizerV2,
                                         GroupShardedOptimizerStage3)
    from ..fleet.meta_parallel import ShardingParallel, shard_parameters_fsdp
    cls = {"os": DygraphShardingOptimizer, "os_g": DygraphShardingOptimizerV2,
           "p_g_os": GroupShardedOptimizerStage3}[level]
    if level == "p_g_os":
        shard_parameters_fsdp(getattr(model, "_layers", model),
                              axis=("dp", "sharding"))
    model = ShardingParallel(model)
    optimizer = cls(getattr(optimizer, "_inner_opt", optimizer))
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the model's state dict (every rank holds the whole model
    after a ZeRO-1/2 step) as ``output/model.pdparams``, and the
    optimizer's as ``model.pdopt``, from the first rank."""
    from .. import env
    from ...framework import save
    inner = getattr(model, "_layers", model)
    if env.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(inner.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
