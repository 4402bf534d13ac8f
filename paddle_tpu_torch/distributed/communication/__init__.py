"""``paddle.distributed.communication`` on ``torch.distributed``."""
from . import stream  # noqa: F401
from .collectives import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    alltoall, alltoall_single, batch_isend_irecv, broadcast,
    broadcast_object_list, irecv, isend, recv, reduce, reduce_scatter,
    scatter, send, staged_bytes,
)
from .group import (  # noqa: F401
    Group, barrier, destroy_process_group, get_backend, get_group,
    is_available, is_initialized, new_group, wait,
)
