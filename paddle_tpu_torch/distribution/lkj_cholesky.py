"""Module alias (the reference's distribution/lkj_cholesky.py)."""
from .distributions import LKJCholesky  # noqa: F401

__all__ = ["LKJCholesky"]
