"""Process groups (counterpart of
``paddle_tpu/distributed/communication/group.py``).

The JAX package's ``Group`` names mesh axes, and its collectives compile
to XLA collectives over them. The port's holds what Paddle's does: the
global ranks of its members, this process's rank among them and a
``torch.distributed`` process group. A group of one member that is not
the world holds no process group: its collectives are the identity. The
world group (``get_group(0)``) is a real process group at any size.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .. import env


class Group:
    """``Group(rank_in_group, id, ranks, pg=None, name=None)`` (Paddle's
    signature): ``rank`` is this process's rank in the group (-1 for a
    non-member), ``ranks`` the members' global ranks."""

    def __init__(self, rank_in_group: int, id: int, ranks: List[int],
                 pg=None, name: Optional[str] = None):
        self.rank = int(rank_in_group)
        self.id = int(id)
        self.ranks = [int(r) for r in ranks]
        self.pg = pg
        self.name = name or f"group_{id}"

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def process_group(self):
        return self.pg

    @property
    def backend(self) -> Optional[str]:
        return env.backend()

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, rank: int) -> int:
        """The group rank of global ``rank``, -1 if it is no member."""
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, rank={self.rank}, "
                f"ranks={self.ranks}, backend={self.backend})")


_groups: dict = {}
_next_id = [1]


def _make_world_group() -> Group:
    world = env.get_world_size()
    g = Group(env.get_rank(), 0, list(range(world)), dist.group.WORLD,
              name="_default_pg")
    _groups[0] = g
    return g


def _get_global_group() -> Group:
    g = _groups.get(0)
    if g is None:
        raise RuntimeError(
            "no process group: call paddle_tpu_torch.distributed."
            "init_parallel_env() (or fleet.init) first")
    return g


def _resolve(group) -> Group:
    return _get_global_group() if group is None else group


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group of the global ``ranks`` (every rank when None). Every rank
    of the world must call it, in the same order, as torch requires; a
    non-member gets a group with ``rank == -1``."""
    world = _get_global_group()
    if ranks is None:
        ranks = list(range(world.nranks))
    ranks = sorted(int(r) for r in ranks)
    me = env.get_rank()
    gid = _next_id[0]
    _next_id[0] += 1
    if ranks == world.ranks:
        pg = world.pg
    elif len(ranks) == 1:
        pg = None            # a group of one: its collectives are identity
    else:
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks=ranks, backend=backend, **kw)
    g = Group(ranks.index(me) if me in ranks else -1, gid, ranks, pg)
    _groups[gid] = g
    return g


def get_group(id=0) -> Group:
    return _groups[0] if id in (None, 0) else _groups[id]


def is_available() -> bool:
    return dist.is_available()


def is_initialized() -> bool:
    return env.is_initialized()


def get_backend(group=None) -> str:
    """"NCCL" or "GLOO", as Paddle names them."""
    _resolve(group)
    return env.backend().upper()


def destroy_process_group(group=None):
    """Without ``group``: leave the world (every group, the mesh and the
    hybrid topology go with it). With one: forget it."""
    if group is not None and group.id != 0:
        _groups.pop(group.id, None)
        if group.pg is not None and group.pg is not dist.group.WORLD:
            dist.destroy_process_group(group.pg)
        return
    from .. import mesh as mesh_mod
    mesh_mod._reset()
    _groups.clear()
    _next_id[0] = 1
    if dist.is_initialized():
        dist.destroy_process_group()
    env._reset()


class _Done:
    """The task of a collective that has completed (every op runs
    synchronously, ``sync_op`` or not)."""

    def wait(self, timeout=None):
        return True

    def is_completed(self):
        return True


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for the work queued on ``tensor``'s device (every collective
    is issued in order on the current stream)."""
    data = getattr(tensor, "_data", tensor)
    if isinstance(data, torch.Tensor) and data.is_cuda:
        torch.cuda.current_stream(data.device).synchronize()
    return tensor


def barrier(group=None):
    """Every member of ``group`` meets: an all-reduce of one element on
    the group's device (the rank's card under NCCL, the CPU under gloo)."""
    g = _resolve(group)
    if g.pg is None or not g.is_member():
        return
    dev = env.device() if env.backend() == "nccl" else torch.device("cpu")
    t = torch.zeros(1, device=dev)
    dist.all_reduce(t, group=g.pg)
    if t.is_cuda:
        torch.cuda.current_stream(dev).synchronize()
