"""In-process stall watcher for host-driven loops.

The port's copy of ``Heartbeat`` from
``paddle_tpu/distributed/watchdog.py``: the serving engine's
``run(heartbeat_timeout=...)`` attaches one. The launcher heartbeats
that go across ranks (the TCPStore keys, ``monitor_dump``) come with the
distributed slice.
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class Heartbeat:
    """Self-contained in-process stall watcher: a daemon thread fires
    ``on_stall(age_seconds)`` ONCE when ``tick()`` hasn't been called
    for ``timeout`` seconds, re-arming on the next tick. It watches ONE
    loop inside one process — the serving engine's ``run()`` attaches
    it so a wedged step (a hung kernel, a stuck host hook) triggers a
    stack dump + state snapshot instead of silent death
    (``Engine.run(heartbeat_timeout=...)``).

        hb = Heartbeat(5.0, on_stall=lambda age: dump(age))
        hb.start()
        while serving:
            engine.step(); hb.tick()
        hb.stop()

    The callback runs on the watcher thread while the watched loop may
    still be stuck — it must only touch host state (the engine's stall
    report snapshots with ``sync=False`` for this reason).
    Callback exceptions are swallowed: diagnostics never kill the
    watcher."""

    def __init__(self, timeout: float, on_stall,
                 interval: Optional[float] = None,
                 name: str = "paddle-heartbeat"):
        if float(timeout) <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.timeout = float(timeout)
        self.on_stall = on_stall
        self.interval = (float(interval) if interval is not None
                         else max(0.005, self.timeout / 4))
        self.name = name
        self.stalls = 0
        self._last = time.time()
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._last = time.time()
        self._fired = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch,
                                        daemon=True, name=self.name)
        self._thread.start()
        return self

    def tick(self) -> None:
        """Mark forward progress; re-arms the one-shot stall alarm."""
        self._last = time.time()
        self._fired = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _watch(self) -> None:
        while not self._stop.is_set():
            age = time.time() - self._last
            if age > self.timeout and not self._fired:
                self._fired = True          # one shot per stall
                self.stalls += 1
                try:
                    self.on_stall(age)
                except Exception:  # noqa: BLE001 — diagnostics only
                    pass
            self._stop.wait(self.interval)
