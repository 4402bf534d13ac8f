"""paddle.sparse.nn.functional of the port (counterpart of
``paddle_tpu/sparse/nn/functional.py``): activations over the stored
values, softmax, and the convolutions and pooling.

The convolutions keep the JAX package's semantics: the input is made
dense, convolved with the port's dense ``conv2d`` / ``conv3d``
(channels-last layout moved to channels-first and back), masked to the
input's active sites for a submanifold conv, and made sparse again with
every nonzero element an entry. At a detector's voxel grid the dense
tensors are the memory cost (a rulebook gather-GEMM-scatter would not
densify; the JAX package does not have one)."""
from __future__ import annotations

import torch

from .. import SparseTensor, _dense, _from_dense
from ...core.dispatch import wrap

__all__ = ["relu", "relu6", "leaky_relu", "softmax", "attention", "conv2d",
           "conv3d", "subm_conv2d", "subm_conv3d", "subm_conv2d_igemm",
           "subm_conv3d_igemm", "max_pool3d"]


def _on_values(x: SparseTensor, fn):
    return x._with_values(fn(x._vals))


def relu(x, name=None):
    return _on_values(x, torch.relu)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _on_values(x, lambda d: torch.where(d >= 0, d,
                                               negative_slope * d))


def relu6(x, name=None):
    return _on_values(x, lambda d: torch.clamp(d, 0, 6))


def softmax(x, axis=-1, name=None):
    """Softmax over the stored entries along ``axis``, the absent ones
    (zeros of the dense tensor) masked out of the normalisation."""
    dense = _dense(x) if isinstance(x, SparseTensor) else x._data
    present = dense != 0
    scores = torch.where(present, dense,
                         torch.full_like(dense, float("-inf")))
    out = torch.softmax(scores, dim=axis)
    return _from_dense(torch.where(present, out, torch.zeros_like(out)))


def attention(query, key, value, sparse_mask, key_padding_mask=None,
              attn_mask=None, name=None):
    """Attention restricted to a sparse mask: not provided, as in the JAX
    package (``nn.functional.sparse_attention`` takes the CSR form)."""
    raise NotImplementedError(
        "use paddle.nn.functional.sparse_attention (CSR offsets/columns "
        "form) — the fused QKV-sparse kernel shape is CUDA-specific")


def _dense_conv(x, weight, bias, stride, padding, dilation, groups, nd,
                subm):
    """Densify -> dense conv -> (submanifold mask) -> sparsify."""
    from ...nn import functional as dF
    dense = _dense(x)
    # the sparse layout is channels-last [N, *spatial, C]
    perm_in = (0, nd + 1) + tuple(range(1, nd + 1))
    perm_out = (0,) + tuple(range(2, nd + 2)) + (1,)
    conv = dF.conv3d if nd == 3 else dF.conv2d
    out = conv(wrap(dense.permute(perm_in)), weight, bias, stride=stride,
               padding=padding, dilation=dilation, groups=groups)
    out_cl = out._data.permute(perm_out)
    if subm:
        active = torch.any(dense != 0, dim=-1, keepdim=True)
        out_cl = torch.where(active, out_cl, torch.zeros_like(out_cl))
    return _from_dense(out_cl)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NHWC", name=None):
    """Sparse 2-d conv; x: [N, H, W, C] sparse."""
    return _dense_conv(x, weight, bias, stride, padding, dilation,
                       groups, nd=2, subm=False)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NDHWC", name=None):
    """Sparse 3-d conv; x: [N, D, H, W, C] sparse."""
    return _dense_conv(x, weight, bias, stride, padding, dilation,
                       groups, nd=3, subm=False)


def subm_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NHWC", key=None, name=None):
    """Submanifold sparse conv: the output is stored at the input's
    active sites only."""
    return _dense_conv(x, weight, bias, stride, padding, dilation,
                       groups, nd=2, subm=True)


def subm_conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NDHWC", key=None, name=None):
    return _dense_conv(x, weight, bias, stride, padding, dilation,
                       groups, nd=3, subm=True)


# the reference's igemm variants: the same function, another CUDA kernel
subm_conv2d_igemm = subm_conv2d
subm_conv3d_igemm = subm_conv3d


def max_pool3d(x, kernel_size, stride=None, padding=0,
               data_format="NDHWC", name=None):
    """Sparse 3-d max pool through the dense tensor."""
    from ...nn import functional as dF
    out = dF.max_pool3d(wrap(_dense(x).permute(0, 4, 1, 2, 3)), kernel_size,
                        stride, padding)
    return _from_dense(out._data.permute(0, 2, 3, 4, 1))
