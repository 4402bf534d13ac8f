"""Module alias (the reference's sparse/creation.py)."""
from . import sparse_coo_tensor, sparse_csr_tensor  # noqa: F401

__all__ = ["sparse_coo_tensor", "sparse_csr_tensor"]
