"""paddle.autograd.backward (counterpart of ``paddle_tpu/autograd/backward_mode.py``)."""
import torch

from ..core.tensor import Tensor


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``torch.autograd.backward`` over surface tensors; a missing
    gradient seeds ones, as the JAX tape does."""
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    datas = [t._data for t in tensors]
    seeds = [torch.ones_like(d) if g is None else
             (g._data if isinstance(g, Tensor) else torch.as_tensor(
                 g, device=d.device))
             for d, g in zip(datas, grad_tensors)]
    torch.autograd.backward(datas, seeds, retain_graph=retain_graph)
