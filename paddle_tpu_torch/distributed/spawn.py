"""``paddle.distributed.spawn``: one process a rank on this host
(counterpart of ``paddle_tpu/distributed/spawn.py``; reference
distributed/spawn.py).

The JAX package's controller owns every local chip, so its spawn is a
CPU-backend tool. The port's starts ``nprocs`` real processes (the
``spawn`` start method), each with the launcher's environment
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``,
``PADDLE_LOCAL_SIZE``, ``PADDLE_MASTER`` on a free local port and, when
given, ``PADDLE_DISTRI_BACKEND``), and runs ``func(*args)`` in each;
``func`` calls ``init_parallel_env`` (or ``fleet.init``); a world it
leaves is destroyed when it returns."""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
from typing import Sequence


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(func, rank, nprocs, master, backend, args):
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_LOCAL_RANK": str(rank), "PADDLE_LOCAL_SIZE": str(nprocs),
        "PADDLE_MASTER": master})
    if backend:
        os.environ["PADDLE_DISTRI_BACKEND"] = backend
    func(*args)
    from .communication.group import destroy_process_group, is_initialized
    if is_initialized():
        # a process group alive at interpreter exit can abort the process
        destroy_process_group()


class SpawnContext:
    def __init__(self, processes):
        self.processes = processes

    def join(self, timeout=None):
        """Wait for every process; RuntimeError if one failed."""
        for p in self.processes:
            p.join(timeout)
        bad = [p.exitcode for p in self.processes if p.exitcode]
        if bad:
            raise RuntimeError(f"spawned process failed with exit code "
                               f"{bad[0]}")
        return True


def spawn(func, args: Sequence = (), nprocs: int = -1, join: bool = True,
          daemon: bool = False, backend=None, master=None, **options):
    """Run ``func(*args)`` in ``nprocs`` processes (default
    ``PADDLE_TRAINERS_NUM``, else 1); returns the ``SpawnContext``,
    joined unless ``join=False``."""
    if nprocs == -1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master = master or f"127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, rank, nprocs, master, backend, args),
                        daemon=daemon)
        p.start()
        procs.append(p)
    context = SpawnContext(procs)
    if join:
        context.join()
    return context
