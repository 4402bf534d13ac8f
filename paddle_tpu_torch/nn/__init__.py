"""paddle.nn of the eager surface (counterpart of ``paddle_tpu/nn``):
``Layer`` and its layers, ``functional``, ``initializer``,
``Parameter`` / ``ParamAttr``, the gradient clips, ``utils`` and ``quant``
(the quantized linears and the QAT layer names). The torch
``nn.Module``s the port's models are built from live in ``_modules``."""
from ..framework.param_attr import Parameter, ParamAttr
from . import functional, initializer, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import Layer
from . import quant  # noqa: E402  (imports nn.layer)
