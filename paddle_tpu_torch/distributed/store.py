"""TCPStore, the rendezvous key-value store (counterpart of
``paddle_tpu/distributed/store.py``).

The JAX package backs its store with a C++ server of its own over
ctypes; the port's is ``torch.distributed.TCPStore``, the store
``init_process_group`` itself rendezvouses through, so one object serves
the process group and the user's keys (barriers, id exchange).
"""
from __future__ import annotations

import datetime
import time
from typing import Optional

import torch.distributed as dist


class TCPStore:
    """``store = TCPStore(host, port, is_master, world_size, timeout)``:
    rank 0 (``is_master``) serves, every rank connects."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6170,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 300.0):
        self.host, self.port = host, int(port)
        self.is_master = bool(is_master)
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        self.store = dist.TCPStore(
            host, self.port, self.world_size, self.is_master,
            timeout=datetime.timedelta(seconds=self.timeout))
        # per-name barrier epochs, so that a name can be reused
        self._barrier_epoch: dict = {}

    def set(self, key: str, value) -> None:
        v = value if isinstance(value, bytes) else str(value).encode()
        self.store.set(key, v)

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        """The value of ``key``, waiting for it up to ``timeout`` seconds
        (the store's own by default); TimeoutError after."""
        self.wait([key], timeout)
        return self.store.get(key)

    def add(self, key: str, amount: int = 1) -> int:
        return int(self.store.add(key, int(amount)))

    def check(self, key: str) -> bool:
        return bool(self.store.check([key]))

    def delete_key(self, key: str) -> bool:
        return bool(self.store.delete_key(key))

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        keys = [keys] if isinstance(keys, str) else list(keys)
        deadline = time.time() + (timeout or self.timeout)
        while not self.store.check(keys):
            if time.time() > deadline:
                raise TimeoutError(f"TCPStore wait({keys!r}) timed out")
            time.sleep(0.02)

    def barrier(self, name: str = "barrier",
                timeout: Optional[float] = None) -> None:
        """All ``world_size`` clients meet; each call on a name takes a
        fresh epoch key, so names are reusable."""
        epoch = self._barrier_epoch.get(name, 0)
        self._barrier_epoch[name] = epoch + 1
        key = f"__barrier/{name}/{epoch}"
        n = self.add(key, 1)
        deadline = time.time() + (timeout or self.timeout)
        while n < self.world_size:
            if time.time() > deadline:
                raise TimeoutError(f"barrier {name!r} timed out at {n}/"
                                   f"{self.world_size}")
            time.sleep(0.02)
            n = self.add(key, 0)

    def close(self):
        self.store = None


_default_store = None


def set_default_store(store: "TCPStore") -> None:
    """Register the process-wide rendezvous store."""
    global _default_store
    _default_store = store


def default_store():
    """The process-wide TCPStore, or None."""
    return _default_store
