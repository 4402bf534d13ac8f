"""The port's hand-written Hopper kernels and their plain versions.

``paged_attention.paged_decode``, ``flash_attention.flash_fwd``,
``flash_attention.flash_bwd``, ``moe.grouped_ffn_fwd`` and
``moe.grouped_ffn_bwd`` launch ``csrc/paged_decode.cu``,
``csrc/flash_fwd.cu``, the two kernels of ``csrc/flash_bwd.cu``,
``csrc/grouped_ffn_fwd.cu`` and the dx and dw kernels of
``csrc/grouped_ffn_bwd.cu`` on CUDA tensors and run their plain PyTorch
versions on CPU tensors; ``probe`` launches the capability probe every
kernel library carries (``_build``).
"""
from ._build import probe

__all__ = ["probe"]
