"""Top-level helpers (counterpart of ``paddle_tpu/framework/misc.py``):
``set_printoptions``, ``create_parameter``, ``batch``, ``check_shape``,
``disable_signal_handler`` and the CUDA rng-state pair. The port's
``set_grad_enabled`` is torch's, at the top level."""
from __future__ import annotations

import numpy as np
import torch

from ..core import random as random_mod

_print_options = {
    "precision": 8, "threshold": 1000, "edgeitems": 3,
    "linewidth": 80, "sci_mode": False,
}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Configure Tensor repr formatting (paddle.set_printoptions): the
    numpy print options ``Tensor.__repr__`` renders through."""
    if precision is not None:
        _print_options["precision"] = int(precision)
    if threshold is not None:
        _print_options["threshold"] = int(threshold)
    if edgeitems is not None:
        _print_options["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        _print_options["linewidth"] = int(linewidth)
    if sci_mode is not None:
        _print_options["sci_mode"] = bool(sci_mode)
    np.set_printoptions(
        precision=_print_options["precision"],
        threshold=_print_options["threshold"],
        edgeitems=_print_options["edgeitems"],
        linewidth=_print_options["linewidth"],
        suppress=not _print_options["sci_mode"])


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A free-standing Parameter on the current place (paddle.
    create_parameter), initialized as ``Layer.create_parameter`` does."""
    from ..nn import Layer
    p = Layer().create_parameter(
        shape=list(shape), attr=attr, dtype=dtype, is_bias=is_bias,
        default_initializer=default_initializer)
    if p is not None and name:
        p.name = name
    return p


def batch(reader, batch_size, drop_last=False):
    """Wrap an item reader into a batch reader (paddle.batch)."""
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive value, "
                         f"but got {batch_size}")

    def batch_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


def check_shape(shape):
    """Validate a shape argument: an int32/int64 Tensor, or a list or
    tuple of non-negative ints and Tensors."""
    from ..core.tensor import Tensor
    if isinstance(shape, Tensor):
        if shape.dtype.name not in ("int32", "int64"):
            raise TypeError("shape tensor must be int32 or int64")
        return
    if isinstance(shape, (list, tuple)):
        for ele in shape:
            if isinstance(ele, Tensor):
                continue
            if not isinstance(ele, (int, np.integer)):
                raise TypeError("All elements in `shape` must be integers")
            if ele < 0:
                raise ValueError("All elements in `shape` must be positive")


def disable_signal_handler():
    """No-op: the port installs no process-wide signal handler (the
    DataLoader's workers are torch's)."""


def get_cuda_rng_state():
    """The state of the port's generator on each visible CUDA device, in
    device order (``core.random``; an empty list without a GPU)."""
    return [random_mod.generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state):
    """Restore ``get_cuda_rng_state``'s states (a list, one a device),
    device by device."""
    if len(state) != torch.cuda.device_count():
        raise ValueError(
            f"set_cuda_rng_state: {len(state)} states for "
            f"{torch.cuda.device_count()} CUDA devices")
    for i, st in enumerate(state):
        random_mod.generator(torch.device("cuda", i)).set_state(st)
