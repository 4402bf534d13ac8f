"""jit.save / jit.load (counterpart of ``paddle_tpu/jit/serialization.py``).

The JAX package exports the forward with ``jax.export``; the port with
``torch.export``, in the same two files:

- ``<prefix>.pdmodel``: the exported program (``torch.export.save``) of
  ``forward(params, frozen, buffers, *inputs)``. The weights are inputs
  of the program, not constants in it;
- ``<prefix>.pdiparams``: a pickle of numpy arrays under the JAX
  package's keys ``params``, ``frozen``, ``buffers`` and ``n_inputs``.

``load`` binds the ``.pdiparams`` arrays to the program, so the two files
are one artifact. Shapes are static, as in the JAX package: a ``None`` or
-1 dim of an ``InputSpec`` becomes 1.

The forward is traced in eval mode under ``torch.no_grad()``, with
``FLAGS_check_nan_inf`` off, so no host read of data is left in the
graph. A surface ``Layer`` is exported through an adapter module that
binds its Tensors to the program's inputs (``jit/functional.py``) and
unwraps its outputs; a raw ``torch.nn.Module`` through
``torch.func.functional_call``. The flash forward enters the graph as the
custom op ``paddle_tpu_torch::flash_fwd``, which launches the kernel when
the program runs on the card.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch
from torch import nn

from ..core import flags as flags_mod
from ..core.device import resolve_device
from ..core.tensor import Tensor, _from_numpy, to_numpy
from . import functional
from .api import InputSpec, _is_layer


def _state(layer):
    """(params, frozen, buffers) of a Layer or a Module: {name: torch
    tensor} each."""
    if _is_layer(layer):
        return (functional.get_params(layer), functional.get_frozen(layer),
                functional.get_buffers(layer))
    named = dict(layer.named_parameters())
    return ({n: p for n, p in named.items() if p.requires_grad},
            {n: p for n, p in named.items() if not p.requires_grad},
            dict(layer.named_buffers()))


class _Program(nn.Module):
    """``forward(params, frozen, buffers, *inputs)`` of ``target`` in eval
    mode. The target is held outside the module tree, so the exported
    program carries no copy of its weights."""

    def __init__(self, target):
        super().__init__()
        object.__setattr__(self, "_target", target)

    def forward(self, params, frozen, buffers, *inputs):
        t = self._target
        if _is_layer(t):
            out, _ = functional.functional_call(t, params, buffers, inputs,
                                                frozen=frozen, training=False)
            return out
        return torch.func.functional_call(t, {**params, **frozen,
                                              **buffers}, inputs)


def _spec_example(s, device):
    from ..core import dtype as dtype_mod
    shape = s.shape if isinstance(s, InputSpec) else list(s)
    dt = s.dtype if isinstance(s, InputSpec) else "float32"
    shape = [1 if d is None or d == -1 else int(d) for d in shape]
    return torch.zeros(shape, dtype=dtype_mod.to_torch(dt), device=device)


def _numpy(d):
    return {k: to_numpy(v) for k, v in d.items()}


def save(layer, path, input_spec=None, **config):
    """Export ``layer``'s forward at the ``input_spec`` shapes and write
    ``<path>.pdmodel`` and ``<path>.pdiparams``."""
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (static shapes are "
                         "what make the export possible)")
    params, frozen, buffers = _state(layer)
    first = next(iter({**params, **frozen, **buffers}.values()), None)
    device = first.device if first is not None else resolve_device(None)
    examples = [_spec_example(s, device) for s in input_spec]
    state = [{k: v.detach() for k, v in d.items()}
             for d in (params, frozen, buffers)]
    nan_check = flags_mod.get_flag("check_nan_inf")
    flags_mod.set_flags({"FLAGS_check_nan_inf": False})
    was_training = layer.training
    try:
        with torch.no_grad():
            exported = torch.export.export(
                _Program(layer), (*state, *examples), strict=False)
    finally:
        flags_mod.set_flags({"FLAGS_check_nan_inf": nan_check})
        layer.train() if was_training else layer.eval()
    # the archive would keep the example inputs, the weights among them
    exported.example_inputs = None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    with open(path + ".pdmodel", "wb") as f:
        f.write(buf.getvalue())
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"params": _numpy(params), "frozen": _numpy(frozen),
                     "buffers": _numpy(buffers),
                     "n_inputs": len(examples)}, f)


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return Tensor._from_data(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o) for o in out)
    if isinstance(out, dict):
        return {k: _wrap(v) for k, v in out.items()}
    return out


class TranslatedLayer:
    """A loaded artifact: callable like the original layer (inference),
    on the device chosen at load. Inputs are surface Tensors, torch
    tensors or numpy arrays; outputs are surface Tensors."""

    def __init__(self, program, params, frozen, buffers, n_inputs, device):
        self._program = program
        self.device = device
        on = lambda d: {k: _from_numpy(np.asarray(v)).to(device)  # noqa
                        for k, v in d.items()}
        self._params, self._frozen, self._buffers = (
            on(params), on(frozen), on(buffers))
        self.num_inputs = n_inputs

    def _arg(self, a):
        if isinstance(a, Tensor):
            a = a._data
        elif not isinstance(a, torch.Tensor):
            a = _from_numpy(np.asarray(a))
        return a.to(self.device)

    def __call__(self, *args):
        with torch.no_grad():
            out = self._program(self._params, self._frozen, self._buffers,
                                *[self._arg(a) for a in args])
        return _wrap(out)

    def state_dict(self):
        """The bound weights: {name: torch tensor}."""
        return {**self._params, **self._frozen, **self._buffers}

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("a loaded inference artifact cannot be trained; "
                           "load the state_dict into a Layer instead")


def load(path, device=None, **config):
    """Load ``<path>.pdmodel`` and ``<path>.pdiparams`` onto ``device``
    (``cuda`` by default, raising without a GPU; ``"cpu"`` to run the
    kernels' plain versions)."""
    from torch.export.passes import move_to_device_pass

    from ..kernels import flash_attention  # noqa: F401 — registers the op
    dev = resolve_device(device)
    with open(path + ".pdmodel", "rb") as f:
        exported = torch.export.load(io.BytesIO(f.read()))
    exported = move_to_device_pass(exported, dev)
    with open(path + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    return TranslatedLayer(exported.module(), state["params"],
                           state["frozen"], state.get("buffers", {}),
                           state.get("n_inputs", 1), dev)
