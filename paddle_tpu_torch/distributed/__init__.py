"""Distributed subset of the port: ``fleet.recompute`` (activation
checkpointing) and ``watchdog.Heartbeat`` (the in-process stall watcher
of ``Engine.run``). Meshes, collectives, parallel layers and the
launcher's cross-rank heartbeats come with the distributed slice."""
from . import fleet, watchdog

__all__ = ["fleet", "watchdog"]
