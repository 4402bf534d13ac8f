"""Throughput timer (counterpart of ``paddle_tpu/profiler/timer.py``).

``benchmark()`` returns the global Benchmark whose hooks a training loop
calls around every batch to report ips (items/sec), warmup skipped.
"""
from __future__ import annotations

import time
from typing import Optional


class _Stats:
    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.batch_size = 0

    @property
    def avg(self):
        return self.total / self.count if self.count else 0.0


class Benchmark:
    def __init__(self):
        self._enabled = False
        self.current_event: Optional[_Stats] = None
        self._start = None
        self._warmup = 10
        self._seen = 0

    def enable(self):
        self._enabled = True
        self.current_event = _Stats()
        self._seen = 0

    def disable(self):
        self._enabled = False

    def begin(self):
        if self._enabled:
            self._start = time.perf_counter()

    def step(self, num_samples: Optional[int] = None):
        if not self._enabled or self._start is None:
            return
        dt = time.perf_counter() - self._start
        self._seen += 1
        if self._seen > self._warmup:
            self.current_event.count += 1
            self.current_event.total += dt
            if num_samples:
                self.current_event.batch_size = num_samples
        self._start = time.perf_counter()

    def end(self):
        self._start = None

    @property
    def ips(self):
        ev = self.current_event
        if ev is None or ev.avg == 0:
            return 0.0
        return (ev.batch_size or 1) / ev.avg

    def report(self):
        return {"ips": self.ips, "avg_batch_sec": self.current_event.avg
                if self.current_event else 0.0}


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    return _benchmark
