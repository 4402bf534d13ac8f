"""fleet, the hybrid-parallel facade (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``; reference fleet.py:218).

``fleet.init`` joins the world (``init_parallel_env``), builds the rank
mesh of the strategy's degrees, with the spare ranks as data parallelism
(JAX :50-88: every rank ``dp`` when no degree is set; the degrees' product
times ``dp`` when it divides the world), makes every axis's process
groups (every rank, in one order) and the hybrid topology.
``distributed_model`` / ``distributed_optimizer`` then wrap the model and
the optimizer, and ``parallel_step.DistributedTrainStep`` trains them.
Parameter-server mode (a ``PSERVER`` role or server endpoints, JAX
:63-70) raises: it comes with the launcher's ps slice.

``recompute`` (activation checkpointing) is the encoder / decoder
models' own, and stays importable from here.
"""
from __future__ import annotations

from typing import Optional

from .. import env as env_mod
from .. import mesh as mesh_mod
from . import base, layers, meta_optimizers, meta_parallel  # noqa: F401
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.role_maker import (PaddleCloudRoleMaker, Role,  # noqa: F401
                              UserDefinedRoleMaker)
from .base.topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group, set_hybrid_communicate_group,
)
from .meta_optimizers import (DygraphShardingOptimizer,  # noqa: F401
                              DygraphShardingOptimizerV2,
                              HybridParallelGradScaler,
                              HybridParallelOptimizer)
from .model import distributed_model  # noqa: F401
from .optimizer import distributed_optimizer  # noqa: F401
from .recompute import (checkpoint_name, recompute,  # noqa: F401
                        recompute_sequential, save_only_names)
from . import utils  # noqa: F401,E402

_fleet_initialized = False
_strategy: Optional[DistributedStrategy] = None
_role_maker = None


def init(role_maker=None, is_collective=True, strategy=None, log_level=None,
         **init_kwargs):
    """Join the world and build the hybrid topology (JAX :50-88).
    ``init_kwargs`` go to ``init_parallel_env`` (``device="cpu"``,
    ``backend=``, ``store=``, ...)."""
    global _fleet_initialized, _strategy, _role_maker
    _strategy = strategy or DistributedStrategy()
    _role_maker = role_maker or PaddleCloudRoleMaker(
        is_collective=is_collective)
    if _role_maker.is_server() or (
            getattr(_role_maker, "_server_endpoints", None)
            and not getattr(_role_maker, "_is_collective", is_collective)):
        raise NotImplementedError(
            "parameter-server training comes with the launcher's ps slice "
            "of the port (ROADMAP D6)")
    env_mod.init_parallel_env(**init_kwargs)
    world = env_mod.get_world_size()
    degrees = dict(_strategy.hybrid_degrees())
    need = 1
    for v in degrees.values():
        need *= v
    if need <= 1:
        degrees["dp"] = world
    elif need < world and world % need == 0:
        degrees["dp"] = degrees.get("dp", 1) * (world // need)
    mesh = mesh_mod.build_mesh(degrees)
    mesh_mod.set_mesh(mesh)
    # every group now, by every rank in one order (torch needs each rank
    # to make each group); later asks are cache hits
    for axes in mesh.axis_names + (("dp", "sharding"),
                                   ("dp", "sharding", "sep")):
        mesh.group(axes)
    mesh_mod.set_hybrid_communicate_group(mesh_mod.HybridCommunicateGroup())
    _fleet_initialized = True


def is_initialized() -> bool:
    return _fleet_initialized


def get_strategy() -> Optional[DistributedStrategy]:
    return _strategy


def worker_index() -> int:
    return env_mod.get_rank()


def worker_num() -> int:
    return env_mod.get_world_size()


def is_first_worker() -> bool:
    return worker_index() == 0


def worker_endpoints(to_string=False):
    """The launcher's ``PADDLE_TRAINER_ENDPOINTS`` (one ``host:port`` a
    rank)."""
    import os
    eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                     "").split(",") if e]
    return ",".join(eps) if to_string else eps


def barrier_worker():
    from ..communication.group import barrier
    barrier()


def is_server() -> bool:
    return False


def is_worker() -> bool:
    return True


def _reset():
    global _fleet_initialized, _strategy, _role_maker
    _fleet_initialized, _strategy, _role_maker = False, None, None
