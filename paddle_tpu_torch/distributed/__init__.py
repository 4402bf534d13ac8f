"""``paddle_tpu_torch.distributed``: collective training on
``torch.distributed`` (counterpart of ``paddle_tpu/distributed``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` and
lets XLA insert the collectives. The port runs one rank a process, as
PaddlePaddle does: ``init_parallel_env`` (``env.py``) joins a process
group (NCCL, or gloo with host staging when ranks share a card),
``communication`` holds the groups and the eager collectives, ``mesh``
the rank grid over ``("pp", "dp", "sharding", "sep", "mp")`` and the
hybrid topology, ``fleet`` the tensor-parallel layers on local shards,
the meta-parallel wrappers (``DataParallel``, ``TensorParallel``,
``ShardingParallel``) and the hybrid / ZeRO-1-2 optimizers,
``parallel_step.DistributedTrainStep`` the hybrid train step (ZeRO
stages 1-3), ``sharding`` the group-sharded API, ``spawn`` and ``launch``
the processes. Pipeline parallelism: ``fleet.meta_parallel``'s
``PipelineLayer`` and ``PipelineParallel`` over ``pipeline`` (the rank
runtime and the schedules), ``zero_bubble``, ``mpmd_graph`` (the
schedules' event graphs) and ``mpmd_runtime`` (the one-process MPMD
driver). ``fleet.recompute`` is activation checkpointing and
``watchdog.Heartbeat`` the in-process stall watcher of ``Engine.run``.

Sequence, segment and expert parallelism: ``fleet.utils.
sequence_parallel_utils``, ring attention over the ``sep`` group
(``kernels/ring_attention.py``), ``SegmentParallel`` and the MoE ``ep``
axis.

Not here yet: auto_parallel and distributed checkpoints (ROADMAP D4),
the launcher's cross-rank heartbeats, elastic, rpc and ps (D6).
"""
from . import communication, env, fleet, launch, mesh  # noqa: F401
from . import parallel_step, sharding, store, watchdog  # noqa: F401
from .communication import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    alltoall, alltoall_single, barrier, batch_isend_irecv, broadcast,
    broadcast_object_list, destroy_process_group, get_backend, get_group,
    irecv, is_available, isend, new_group, recv, reduce, reduce_scatter,
    scatter, send, wait,
)
from .communication.group import Group  # noqa: F401
from .env import (  # noqa: F401
    get_rank, get_world_size, init_parallel_env, is_initialized,
)
from .fleet.meta_parallel import DataParallel  # noqa: F401
from .mesh import build_mesh, get_mesh, set_mesh  # noqa: F401
from .parallel_step import DistributedTrainStep  # noqa: F401
from .spawn import spawn  # noqa: F401
from .store import TCPStore  # noqa: F401


class ParallelEnv:
    """The rank's view of the launcher's environment (reference
    parallel.py ParallelEnv)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return env.get_local_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def device_id(self):
        dev = env.device()
        return dev.index if dev.type == "cuda" and dev.index is not None \
            else 0
