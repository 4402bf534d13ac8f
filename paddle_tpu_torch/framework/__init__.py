"""paddle.framework (counterpart of ``paddle_tpu/framework``): ``ParamAttr``
/ ``Parameter`` and ``save`` / ``load``."""
from .io import load, save
from .param_attr import Parameter, ParamAttr

__all__ = ["load", "save", "Parameter", "ParamAttr"]
