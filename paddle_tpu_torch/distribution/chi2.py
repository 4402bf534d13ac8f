"""Module alias (the reference's distribution/chi2.py)."""
from .distributions import Chi2  # noqa: F401

__all__ = ["Chi2"]
