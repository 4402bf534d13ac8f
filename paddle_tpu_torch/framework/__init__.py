"""paddle.framework (counterpart of ``paddle_tpu/framework``): ``ParamAttr``
/ ``Parameter``, ``save`` / ``load``, and the seed, default-dtype, Tensor
and mode names the JAX package also exports here."""
from ..core.dtype import get_default_dtype, set_default_dtype
from ..core.random import get_rng_state, seed, set_rng_state
from ..core.tensor import Tensor
from .io import load, save
from .param_attr import Parameter, ParamAttr


def in_dynamic_mode():
    """True: dygraph is the only mode (``jit.to_static`` compiles, it
    opens no static Program)."""
    return True


def in_pir_mode():
    """False, as in the JAX package: there is no PIR program mode."""
    return False


__all__ = ["load", "save", "Parameter", "ParamAttr", "seed",
           "get_rng_state", "set_rng_state", "get_default_dtype",
           "set_default_dtype", "Tensor", "in_dynamic_mode", "in_pir_mode"]
