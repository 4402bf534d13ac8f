"""``InputSpec`` and ``TrainStep`` (counterparts of
``paddle_tpu/jit/api.py:31`` and ``:443``).

    step = TrainStep(model, loss_fn, optimizer, amp_dtype="bfloat16")
    loss = step(inputs, labels)        # f32 scalar tensor

``model`` is a raw ``torch.nn.Module`` (the port's model families) or a
surface ``Layer``. A Layer's weights are bound through
``jit/functional.py`` (``bind_state``) where a Module's go through
``torch.func.functional_call``; its inputs and labels reach it and
``loss_fn`` as surface ``Tensor``s, and its optimizer is a surface one
(``parameters=layer.parameters()``), whose Parameters' leaves the step
updates in place. Everything below holds for both.

One call runs forward, loss, backward, gradient clipping and the
optimizer update. The JAX ``TrainStep`` compiles that into one donated
``jax.jit`` executable and swaps the model's arrays for the new ones;
PyTorch runs it eagerly, and the port updates the model's parameters
and the optimizer state IN PLACE instead of donating them, so no step
holds two copies of the weights or of the moments.

- ``amp_dtype`` has the JAX package's O2 semantics (:476-487): every
  floating parameter is cast to the amp dtype for the forward (the f32
  parameters stay the masters) and floating inputs are cast too; ids,
  labels and flashmask bands stay integers. The cast weights are bound
  to the model with ``torch.func.functional_call``, which also covers
  the backward, so a recomputed (checkpointed) layer reruns on the same
  cast weights; the gradients land on the f32 masters.
- The loss is cast to f32 (:499); the gradients come from
  ``torch.autograd.grad`` (nothing accumulates in ``.grad``, as with
  ``jax.value_and_grad``); a parameter the loss does not reach gets a
  zero gradient.
- Then the optimizer's ``grad_clip`` (:506-507), then
  ``apply_gradients_pytree`` (:508) at ``optimizer.get_lr()`` (read at
  every call, so an ``lr.LRScheduler`` drives the steps, :553) with no
  decay mask: AdamW decays every parameter, as in the JAX package. Any of
  the port's per-parameter optimizers runs there; Adam and AdamW update
  every f32 parameter on the card in one fused launch
  (``kernels/fused_adam.py``).

The step follows the model's device: inputs and labels (tensors or numpy
arrays) are moved there. Left out: the ``analysis`` lint on the first
compile (:550-551) and the distributed watchdog (:563-564).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.tensor import Tensor
from . import functional


class InputSpec:
    """Shape / dtype spec (paddle.static.InputSpec). A ``None`` or -1 dim
    is a wildcard."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    def matches(self, shape, dtype) -> Optional[str]:
        """None if (shape, dtype) satisfies the spec, else the reason."""
        from ..core import dtype as dtype_mod
        shape = tuple(shape)
        if len(shape) != len(self.shape):
            return (f"rank mismatch: got {list(shape)}, spec expects "
                    f"{self.shape}")
        for got, want in zip(shape, self.shape):
            if want not in (None, -1) and got != want:
                return (f"shape mismatch: got {list(shape)}, spec expects "
                        f"{self.shape}")
        try:
            want_dt = dtype_mod.dtype(self.dtype)
        except (TypeError, ValueError):
            # a typo'd spec dtype must not silently disable the check
            return (f"spec dtype {self.dtype!r} is not a known dtype "
                    "(typo in the InputSpec?)")
        try:
            got_dt = dtype_mod.dtype(dtype)
        except (TypeError, ValueError):
            got_dt = dtype_mod.dtype(np.dtype(dtype).name)
        if got_dt != want_dt:
            return f"dtype mismatch: got {dtype}, spec expects {self.dtype}"
        return None

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _as_tensor(x, device):
    if x is None:
        return x
    if isinstance(x, (list, tuple)):
        return type(x)(_as_tensor(a, device) for a in x)
    if isinstance(x, Tensor):
        return x._data.to(device)
    return torch.as_tensor(x, device=device)


def _wrap_tree(x):
    if isinstance(x, torch.Tensor):
        return Tensor._from_data(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap_tree(a) for a in x)
    return x


def _is_layer(model):
    from ..nn.layer.layers import Layer
    return isinstance(model, Layer)


class _LossAndGrads(nn.Module):
    """forward, loss and ``autograd.grad`` in one module call, so that
    ``functional_call`` keeps the cast weights bound through the
    backward as well."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, inputs, labels, loss_fn, masters):
        out = self.model(*inputs)
        loss = loss_fn(out, labels).float()
        grads = torch.autograd.grad(loss, masters, materialize_grads=True)
        return loss.detach(), list(grads)


class TrainStep:
    """``loss = step(inputs, labels)``: one training step of ``model``
    under ``loss_fn(model(*inputs), labels)`` with ``optimizer``. Non-tuple
    ``inputs`` are one positional input. ``donate`` is accepted for API
    parity: the update is in place either way."""

    def __init__(self, model, loss_fn, optimizer, amp_dtype=None,
                 donate=True):
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._amp_dtype = None if amp_dtype is None else (
            amp_dtype if isinstance(amp_dtype, torch.dtype)
            else getattr(torch, str(amp_dtype)))
        self._layer = _is_layer(model)
        self._runner = None if self._layer else _LossAndGrads(model)
        self.sync_from_model()
        self._opt_state = optimizer.init_state_pytree(self._params)

    @property
    def opt_state(self):
        """{param name: {slot: tensor}} — the optimizer state the steps
        update (``bridge.adam_state_to_numpy`` reads it; assign the output
        of ``bridge.adam_state_from_numpy`` to resume a run)."""
        return self._opt_state

    @opt_state.setter
    def opt_state(self, state):
        if sorted(state) != sorted(self._params):
            raise ValueError("optimizer state must name exactly the "
                             "trainable parameters")
        self._opt_state = state

    def _cast(self, t):
        if self._amp_dtype is not None and isinstance(t, torch.Tensor) \
                and t.is_floating_point():
            return t.to(self._amp_dtype)
        return t

    def __call__(self, inputs, labels):
        loss, grads = self.loss_and_grads(inputs, labels)
        self._opt.apply_gradients_pytree(self._params, grads,
                                         self._opt_state, self._opt.get_lr())
        return loss

    def loss_and_grads(self, inputs, labels):
        """The step without its update: (loss, {parameter name: gradient}),
        the gradients clipped by the optimizer's ``grad_clip``."""
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        inputs = tuple(self._cast(x) for x in _as_tensor(tuple(inputs),
                                                          self._device))
        labels = _as_tensor(labels, self._device)
        names = list(self._params)
        masters = [self._params[n] for n in names]
        with torch.enable_grad():
            if self._layer:
                loss, grads = self._layer_loss_and_grads(
                    names, masters, inputs, labels)
            else:
                bound = {"model." + n: self._cast(m)
                         for n, m in zip(names, masters)}
                loss, grads = torch.func.functional_call(
                    self._runner, bound, (inputs, labels, self._loss_fn,
                                          masters))
                del bound
        clip = self._opt._grad_clip
        if clip is not None:
            grads = clip.clip_grads(grads)
        return loss, dict(zip(names, grads))

    def _layer_loss_and_grads(self, names, masters, inputs, labels):
        """A surface Layer's forward on the cast weights (bound through
        ``functional_call``, in training mode), ``loss_fn`` on surface
        Tensors, the f32 loss's gradients on the masters."""
        bound = {n: self._cast(m) for n, m in zip(names, masters)}
        out, _ = functional.functional_call(self._model, bound, {}, inputs,
                                            training=True)
        loss = self._loss_fn(_wrap_tree(out), _wrap_tree(labels))
        loss = (loss._data if isinstance(loss, Tensor) else loss).float()
        grads = torch.autograd.grad(loss, masters, materialize_grads=True)
        return loss.detach(), list(grads)

    def sync_to_model(self):
        """The parameters are updated in place, so only the optimizer's
        eager state is refreshed from the step's."""
        for name, state in self._opt_state.items():
            self._opt._accumulators[id(self._params[name])] = state

    def sync_from_model(self):
        """Re-read the model's trainable parameters (e.g. after
        ``load_state_dict`` replaced them)."""
        if self._layer:
            self._params = functional.get_params(self._model)
        else:
            self._params = {n: p for n, p in self._model.named_parameters()
                            if p.requires_grad}
        self._device = next(iter(self._params.values())).device

    @property
    def loss_scale(self):
        """No loss scaling inside the train step (:581-583)."""
        return 1.0


def compile_train_step(model, loss_fn, optimizer, **kw):
    """``TrainStep(model, loss_fn, optimizer, **kw)`` (:611)."""
    return TrainStep(model, loss_fn, optimizer, **kw)
