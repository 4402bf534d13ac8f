"""Distributed subset of the port: ``fleet.recompute`` (activation
checkpointing). Meshes, collectives and parallel layers come with the
distributed slice."""
from . import fleet

__all__ = ["fleet"]
