"""paddle.autograd over torch autograd (counterpart of ``paddle_tpu/autograd``)."""
import torch

from .backward_mode import backward
from .functional import grad, hessian, jacobian, jvp, vjp
from .py_layer import (PyLayer, PyLayerContext, once_differentiable,
                       saved_tensors_hooks)

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled

__all__ = ["backward", "grad", "hessian", "jacobian", "jvp", "vjp",
           "PyLayer", "PyLayerContext", "once_differentiable",
           "saved_tensors_hooks", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled"]
