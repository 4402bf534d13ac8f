"""The hybrid topology's fleet import path (reference
fleet/base/topology.py:70,189): the implementation is
``paddle_tpu_torch.distributed.mesh``."""
from ...mesh import (  # noqa: F401
    HYBRID_AXES, CommunicateTopology, HybridCommunicateGroup, axis_degree,
    build_mesh, ensure_mesh, get_hybrid_communicate_group, get_mesh,
    set_hybrid_communicate_group, set_mesh,
)
