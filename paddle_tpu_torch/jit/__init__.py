"""paddle.jit of the port (counterpart of ``paddle_tpu/jit``):
``to_static`` (``StaticFunction``: Dynamo + Inductor, one compiled entry
an input signature), the whole-step ``TrainStep``, ``InputSpec``, the
Layer functionalization (``functional_call``, ``get_params``,
``get_buffers``) and ``save`` / ``load`` through ``torch.export``."""
import logging

from .api import (InputSpec, StaticFunction, TrainStep, compile_train_step,
                  enable_to_static, not_to_static, to_static)
from .functional import functional_call, get_buffers, get_params
from .serialization import TranslatedLayer, load, save

__all__ = ["InputSpec", "StaticFunction", "TrainStep", "TranslatedLayer",
           "compile_train_step", "enable_to_static", "functional_call",
           "get_buffers", "get_params", "ignore_module", "load",
           "not_to_static", "save", "set_code_level", "set_verbosity",
           "to_static"]

_ignored_modules: list = []


def ignore_module(modules):
    """Record modules a bytecode tracer should skip (paddle.jit.
    ignore_module); the port traces nothing by bytecode, so the list is
    kept for introspection only."""
    if not isinstance(modules, (list, tuple)):
        modules = [modules]
    _ignored_modules.extend(modules)


def set_code_level(level=100, also_to_stdout=False):
    """Transformed-code logging (paddle.jit.set_code_level): there is no
    code transform here; sets the ``paddle_tpu_torch.jit`` logger to
    DEBUG."""
    logging.getLogger("paddle_tpu_torch.jit").setLevel(logging.DEBUG)


def set_verbosity(level=0, also_to_stdout=False):
    """Set the ``paddle_tpu_torch.jit`` logger's verbosity."""
    logging.getLogger("paddle_tpu_torch.jit").setLevel(
        logging.DEBUG if level > 0 else logging.WARNING)
