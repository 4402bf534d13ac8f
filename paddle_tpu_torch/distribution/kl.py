"""Module alias (the reference's distribution/kl.py)."""
from .distributions import kl_divergence, register_kl  # noqa: F401

__all__ = ["kl_divergence", "register_kl"]
