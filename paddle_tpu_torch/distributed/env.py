"""The process world: one rank a process (counterpart of
``paddle_tpu/distributed/env.py``).

The JAX package runs one controller process a host that owns every
chip, so its rank is ``jax.process_index()``. The port runs one rank a
process, as PaddlePaddle does: ``init_parallel_env`` joins the process
to a ``torch.distributed`` process group and puts it on a device.

- The launcher (``python -m paddle_tpu_torch.distributed.launch``)
  sets ``PADDLE_TRAINER_ID`` (the rank), ``PADDLE_TRAINERS_NUM`` (the
  world size), ``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE`` (the ranks
  this node runs) and ``PADDLE_MASTER`` (``host:port`` of rank 0's
  store); the same names as the JAX package reads (:56-73).
- The device: ``cuda:{local_rank % device_count}``, and a RuntimeError
  when no GPU is visible, unless the caller passes ``device="cpu"``.
- The backend follows from the ranks a node runs against its visible
  cards: NCCL when every local rank has a card of its own, else gloo
  (NCCL refuses two ranks on one card). ``PADDLE_DISTRI_BACKEND`` or an
  explicit ``backend=`` overrides the rule; a CPU rank is always gloo.
  Under gloo, a collective on a CUDA tensor stages it through pinned
  host memory (``communication/collectives.py``).
- A world of one is still a real process group (on an in-memory store).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_state: dict = {}


def _env_int(name, default):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (the world when None); before
    ``init_parallel_env``, the launcher's ``PADDLE_TRAINER_ID`` or 0."""
    if group is not None:
        return group.rank
    if _state:
        return _state["rank"]
    return _env_int("PADDLE_TRAINER_ID", 0)


def get_world_size(group=None) -> int:
    if group is not None:
        return group.world_size
    if _state:
        return _state["world_size"]
    return _env_int("PADDLE_TRAINERS_NUM", 1)


def get_local_rank() -> int:
    if _state:
        return _state["local_rank"]
    return _env_int("PADDLE_LOCAL_RANK", get_rank())


def is_initialized() -> bool:
    return bool(_state)


def backend() -> Optional[str]:
    """The world's backend ("nccl" or "gloo"), None before init."""
    return _state.get("backend")


def device() -> torch.device:
    """The device this rank computes on (set by ``init_parallel_env``);
    before it, ``cuda`` (the port's default device)."""
    return _state.get("device", torch.device("cuda"))


def process_label() -> dict:
    """Rank identity for telemetry consumers: {'rank', 'world_size',
    'initialized'}; rank 0 of 1 before ``init_parallel_env``."""
    return dict(rank=get_rank(), world_size=get_world_size(),
                initialized=is_initialized())


def choose_backend(dev: torch.device, local_size: int,
                   requested: Optional[str] = None) -> str:
    """The backend rule: ``requested`` (or ``PADDLE_DISTRI_BACKEND``) if
    given; gloo for a CPU rank; NCCL when the node's ``local_size`` ranks
    fit its visible cards one a card, gloo otherwise."""
    requested = requested or os.environ.get("PADDLE_DISTRI_BACKEND") or None
    if requested:
        requested = requested.lower()
        if requested not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                             f"{requested!r}")
        if requested == "nccl" and dev.type != "cuda":
            raise ValueError("the NCCL backend needs a CUDA device")
        return requested
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if local_size <= torch.cuda.device_count() else "gloo"


def _resolve_rank_device(device, local_rank):
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: a rank runs on an NVIDIA GPU by "
            "default; pass device='cpu' (and backend='gloo') to run the "
            "ranks on the CPU")
    if device is not None and torch.device(device).index is not None:
        dev = torch.device(device)
    else:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _default_store(rank, world_size, timeout):
    if world_size == 1:
        return dist.HashStore()
    master = os.environ.get("PADDLE_MASTER")
    if master:
        host, port = master.rsplit(":", 1)
    else:
        host = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not host or not port:
            raise RuntimeError(
                "init_parallel_env: a world of more than one rank needs a "
                "store: PADDLE_MASTER=host:port (the launcher sets it), "
                "MASTER_ADDR / MASTER_PORT, or store=")
    return dist.TCPStore(host, int(port), world_size, rank == 0,
                         timeout=timeout)


def init_parallel_env(backend=None, device=None, store=None, rank=None,
                      world_size=None, local_rank=None, local_size=None,
                      timeout: float = 600.0):
    """Join this process to the world (``paddle.distributed.
    init_parallel_env``, JAX :56-73) and return the world ``Group``.
    ``rank`` / ``world_size`` / ``local_rank`` / ``local_size`` default to
    the launcher's environment (rank 0 of 1 without one); ``store`` to a
    ``TCPStore`` at ``PADDLE_MASTER`` (an in-memory store for a world of
    one). Idempotent: a second call returns the world group."""
    from .communication import group as group_mod
    if _state:
        return group_mod._get_global_group()
    rank = _env_int("PADDLE_TRAINER_ID", 0) if rank is None else int(rank)
    world_size = _env_int("PADDLE_TRAINERS_NUM", 1) \
        if world_size is None else int(world_size)
    if local_rank is None:
        local_rank = _env_int("PADDLE_LOCAL_RANK", rank)
    if local_size is None:
        local_size = _env_int("PADDLE_LOCAL_SIZE", world_size)
    dev = _resolve_rank_device(device, int(local_rank))
    be = choose_backend(dev, int(local_size), backend)
    td = datetime.timedelta(seconds=float(timeout))
    if store is None:
        store = _default_store(rank, world_size, td)
    kw = {}
    if be == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(be, store=store, rank=rank,
                            world_size=world_size, timeout=td, **kw)
    _state.update(rank=rank, world_size=world_size,
                  local_rank=int(local_rank), local_size=int(local_size),
                  backend=be, device=dev)
    return group_mod._make_world_group()


def _reset():
    _state.clear()
