"""Eager automatic mixed precision (counterpart of ``paddle_tpu/amp/auto_cast.py``).

``auto_cast`` sets a thread-local state that the first stage of
``core.dispatch.run_op`` reads: by the op's name, O1 casts the floating
inputs of white-listed ops down to the low dtype and those of
black-listed ops up to float32; O2 casts every op's inputs down except
the black list's; OD casts only the white list's. The lists are the JAX
package's (the port keeps its own copy), over the JAX package's op
names. ``torch.autocast`` is not used: its op lists are not paddle's, so
dtypes would differ op by op. Only float32 / bfloat16 / float16 inputs
are cast, through the differentiable ``cast`` op.
"""
from __future__ import annotations

import contextlib
import threading

import torch

WHITE_LIST = {
    "matmul", "mm", "bmm", "einsum", "conv2d", "conv1d", "conv3d",
    "conv2d_transpose", "linear", "addmm", "attention", "flash_attention",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax",
    "log_softmax", "cross_entropy", "softmax_with_cross_entropy", "erf",
    "erfinv", "pow", "square", "reciprocal", "rsqrt", "sum", "mean", "norm",
    "cumsum", "cumprod", "var", "std", "renorm", "prod",
    "sigmoid_cross_entropy_with_logits", "binary_cross_entropy", "nll_loss",
    "kl_div", "cosine_similarity", "layer_norm", "batch_norm",
    "instance_norm", "group_norm",
}

# dtype-preserving / bookkeeping ops that are never cast (``cast`` itself
# would recurse)
_AMP_EXEMPT = {
    "cast", "assign", "getitem", "setitem", "clone", "reshape", "transpose",
    "concat", "stack", "split", "squeeze", "unsqueeze", "expand", "tile",
    "shape", "numel",
}
_CASTABLE = (torch.float32, torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.dtype = "bfloat16"
        self.custom_white = set()
        self.custom_black = set()


_amp_state = _AmpState()


def amp_state():
    return _amp_state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast context manager."""
    if level not in ("O0", "O1", "O2", "OD"):
        raise ValueError(f"level should be O0/OD/O1/O2, got {level}")
    st = _amp_state
    prev = (st.enabled, st.level, st.dtype, st.custom_white, st.custom_black)
    st.enabled = bool(enable) and level != "O0"
    st.level = level
    st.dtype = dtype
    st.custom_white = set(custom_white_list or ())
    st.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (st.enabled, st.level, st.dtype, st.custom_white,
         st.custom_black) = prev


amp_guard = auto_cast


def _low_dtype():
    return torch.bfloat16 if _amp_state.dtype == "bfloat16" else torch.float16


def autocast_inputs(op_name, tensor_args):
    """Stage 1 of ``run_op`` while AMP is on."""
    from ..core.tensor import Tensor
    if op_name in _AMP_EXEMPT:
        return tensor_args
    st = _amp_state
    white = (WHITE_LIST | st.custom_white) - st.custom_black
    black = (BLACK_LIST | st.custom_black) - st.custom_white
    if st.level == "O2":
        to_low = op_name not in black
    else:  # O1 and OD
        to_low = op_name in white
    if not to_low and op_name not in black:
        return tensor_args
    target = _low_dtype() if to_low else torch.float32

    def cast_one(x):
        if isinstance(x, Tensor) and x._data.dtype != target and \
                x._data.dtype in _CASTABLE:
            from ..ops import manipulation
            return manipulation.cast(x, target)
        return x

    return [cast_one(x) for x in tensor_args]


def amp_decorate(models, optimizers=None, level="O1", dtype="float16",
                 master_weight=None, save_dtype=None):
    """paddle.amp.decorate: O1 leaves the model alone (casting happens
    per op under ``auto_cast``); O2 casts every floating parameter and
    buffer to the low dtype except those of the normalisation layers,
    in place (an optimizer holding the parameters sees the cast), and
    turns on the optimizers' ``_multi_precision`` (f32 master weights)."""
    from ..nn import Layer

    single_model = isinstance(models, Layer)
    model_list = [models] if single_model else list(models or [])
    single_opt = optimizers is not None and not isinstance(
        optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers or [])
    if level not in ("O1", "O2"):
        raise ValueError("level should be O1 or O2")
    if level == "O2":
        from .. import nn
        keep_fp32 = tuple(
            cls for cls in (getattr(nn, n, None) for n in (
                "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
                "SyncBatchNorm", "LayerNorm", "InstanceNorm1D",
                "InstanceNorm2D", "InstanceNorm3D", "GroupNorm"))
            if cls is not None)
        want = torch.bfloat16 if dtype == "bfloat16" else torch.float16
        for m in model_list:
            if not isinstance(m, Layer):
                raise TypeError("models must be nn.Layer instances")
            for lyr in m.sublayers(include_self=True):
                if isinstance(lyr, keep_fp32):
                    continue
                for t in list(lyr._parameters.values()) + \
                        list(lyr._buffers.values()):
                    if t is not None and t._data.is_floating_point():
                        t._data.data = t._data.data.to(want)
            m._amp_level = "O2"
        for opt in opt_list:
            opt._multi_precision = True
    for m in model_list:
        m._amp_save_dtype = save_dtype
    models_out = model_list[0] if single_model else model_list
    if optimizers is None:
        return models_out
    return models_out, (opt_list[0] if single_opt else opt_list)


decorate = amp_decorate
