"""The port's hand-written Hopper kernels and their plain versions.

``paged_attention.paged_decode``, ``flash_attention.flash_fwd`` and
``flash_attention.flash_bwd`` launch ``csrc/paged_decode.cu``,
``csrc/flash_fwd.cu`` and the two kernels of ``csrc/flash_bwd.cu`` on CUDA
tensors and run their plain PyTorch versions on CPU tensors; ``probe``
launches the capability probe every kernel library carries (``_build``).
"""
from ._build import probe

__all__ = ["probe"]
