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

import functools
import inspect as _inspect
import os
import types
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


# -- to_static ---------------------------------------------------------------

def _is_array(x):
    return isinstance(x, (Tensor, torch.Tensor, np.ndarray))


def _sig_of(args, kwargs):
    """The cache key of a call (``_sig_of``, :65): shape and dtype of each
    array argument, ``repr`` of every other one (never an array's values:
    a new entry per batch of data)."""
    parts = []
    for a in args:
        if isinstance(a, Tensor):
            parts.append(("T", tuple(a._data.shape), str(a._data.dtype)))
        elif isinstance(a, (torch.Tensor, np.ndarray)):
            parts.append(("A", tuple(a.shape), str(a.dtype)))
        else:
            parts.append(("S", repr(a)))
    for k in sorted(kwargs):
        v = kwargs[k]
        if isinstance(v, Tensor):
            parts.append((k, tuple(v._data.shape), str(v._data.dtype)))
        elif isinstance(v, (torch.Tensor, np.ndarray)):
            parts.append((k, tuple(v.shape), str(v.dtype)))
        else:
            parts.append((k, repr(v)))
    return tuple(parts)


def _own_code(fn):
    """``fn`` with a code object of its own, so that each signature of
    each StaticFunction is one entry with its own graphs. Dynamo keeps
    its graphs on the code object and caps how many one holds (8), past
    which it runs the frame uncompiled: entries sharing one code object
    (ten sublayers' runners, say) would share, and could exhaust, that
    cache."""
    return types.FunctionType(fn.__code__.replace(), fn.__globals__,
                              fn.__name__, fn.__defaults__, fn.__closure__)


def _dynamo_backend(backend):
    """``to_static``'s ``backend``: None (or Paddle's "CINN", the
    compiler it names) is Inductor; any other value is a Dynamo backend
    (a registered name or a callable)."""
    return "inductor" if backend in (None, "CINN") else backend


def _break_errors():
    """Dynamo's graph break under ``fullgraph=True``: a value-dependent
    branch (``UserError``, data-dependent guard) or code it cannot trace
    (``Unsupported``; inside a ``cond`` / ``while_loop`` branch,
    ``UncapturedHigherOrderOpError``) — the JAX package's
    tracer-concretization errors (:213-218)."""
    from torch._dynamo import exc
    return (exc.Unsupported, exc.UserError,
            exc.UncapturedHigherOrderOpError)


def _sublayers(layer):
    """(name, child) of every sublayer: a surface Layer's
    ``named_sublayers``, a Module's ``named_modules`` without itself."""
    if _is_layer(layer):
        return list(layer.named_sublayers())
    return [(n, m) for n, m in layer.named_modules() if n]


def _params_want_grad(layer):
    if _is_layer(layer):
        return any(not p.stop_gradient for p in layer.parameters())
    return any(p.requires_grad for p in layer.parameters())


def _wants_grad(obj):
    if isinstance(obj, Tensor):
        return not obj.stop_gradient
    if isinstance(obj, torch.Tensor):
        return obj.requires_grad
    if isinstance(obj, (list, tuple)):
        return any(_wants_grad(o) for o in obj)
    if isinstance(obj, dict):
        return any(_wants_grad(o) for o in obj.values())
    return False


class StaticFunction:
    """A function or layer compiled per input signature (counterpart of
    ``paddle_tpu/jit/api.py:88``). Each signature's entry is
    ``torch.compile(..., fullgraph=True, dynamic=False)`` with the
    backend ``to_static`` was given (Inductor by default): Dynamo traces
    the surface ops into one graph, a layer's parameters and buffers
    enter it as inputs (an in-place buffer update is written back), and
    AOTAutograd compiles its backward, so gradients reach the parameters
    and the inputs. The flash kernels enter the graph as the custom ops
    ``paddle_tpu_torch::flash_fwd_lse`` / ``flash_bwd`` (``flash_fwd``
    without a gradient), which launch them at each call.

    A graph break (value-dependent Python, code Dynamo cannot trace)
    warns once and pins the signature to eager; the pin is retried every
    ``_RETRY_AFTER`` calls, at most ``_MAX_RETRIES`` times. A layer's
    eager call then keeps each sublayer compiled on its own
    (``_fallback_call``)."""

    _RETRY_AFTER = 16
    _MAX_RETRIES = 3

    def __init__(self, fn, input_spec=None, build_strategy=None,
                 backend=None, full_graph=True):
        self._fn = fn
        self._layer = None
        if hasattr(fn, "forward") and hasattr(fn, "named_parameters"):
            self._layer = fn
            self._fn = fn.forward
        self._input_spec = input_spec
        self._backend = _dynamo_backend(backend)
        self._cache = {}
        # signature -> eager calls since its pin; retries per signature
        self._eager_sigs = {}
        self._retry_counts = {}
        self._child_sf = None  # per-sublayer compilers of the fallback
        self._warned_break = False
        functools.update_wrapper(self, self._fn)

    @property
    def layer(self):
        return self._layer

    @property
    def input_spec(self):
        return self._input_spec

    def concrete_program(self):
        return None  # no Program: the compiled graphs are Dynamo's

    def _spec_list(self):
        if self._input_spec is None:
            return None
        return list(self._input_spec) \
            if isinstance(self._input_spec, (list, tuple)) \
            else [self._input_spec]

    def _validate_input_spec(self, tensor_args):
        """Reject a call whose array shapes / dtypes contradict the
        stored InputSpec (:137)."""
        for i, (spec, a) in enumerate(zip(self._spec_list() or [],
                                          tensor_args)):
            if not isinstance(spec, InputSpec) or not _is_array(a):
                continue
            arr = a._data if isinstance(a, Tensor) else a
            why = spec.matches(arr.shape, arr.dtype)
            if why is not None:
                name = getattr(self._fn, "__qualname__", "to_static fn")
                raise ValueError(
                    f"{name}: input #{i} violates input_spec: {why}")

    def inspect(self, *args, mesh=None, **kwargs):
        raise NotImplementedError(
            "StaticFunction.inspect lints the traced program: it comes "
            "with the analysis slice of the port (ROADMAP section 1, "
            "item 6)")

    def _maybe_lint_first_compile(self, args, kwargs):
        """The opt-in first-compile lint (``PADDLE_TPU_LINT=1``, :170)."""
        if os.environ.get("PADDLE_TPU_LINT", "0").lower() in (
                "1", "true", "yes", "on"):
            raise NotImplementedError(
                "PADDLE_TPU_LINT: the first-compile lint comes with the "
                "analysis slice of the port (ROADMAP section 1, item 6)")

    def _compile(self):
        if self._layer is None:
            fn = self._fn

            def run(*args, **kwargs):
                return fn(*args, **kwargs)
        else:
            layer = self._layer

            def run(*args, **kwargs):
                return layer(*args, **kwargs)
        return torch.compile(_own_code(run), backend=self._backend,
                             fullgraph=True, dynamic=False)

    def _graph_break(self, exc, args, kwargs):
        if not self._warned_break:
            import warnings
            name = getattr(self._fn, "__qualname__", repr(self._fn))
            how = ("keeping each traceable sublayer compiled and running "
                   "only the parent control flow eagerly"
                   if self._layer is not None else
                   "falling back to eager for this function")
            warnings.warn(
                f"to_static({name}): value-dependent Python control flow "
                f"cannot be traced ({type(exc).__name__}); {how}. Use "
                "paddle.static.nn.cond / while_loop to keep the whole "
                "graph compiled.", stacklevel=3)
            self._warned_break = True
        return self._fallback_call(args, kwargs)

    def _fallback_call(self, args, kwargs):
        """The eager call of a graph-broken signature (:236): a function
        runs eagerly; a layer runs its own forward eagerly with each
        sublayer called from it through its own StaticFunction, so one
        value-dependent branch leaves the other sublayers compiled.
        With a gradient wanted (through the parameters or an input) the
        whole layer runs eagerly, as the JAX package does (:255-264)."""
        if self._layer is None:
            return self._fn(*args, **kwargs)
        layer = self._layer
        if torch.is_grad_enabled() and (_params_want_grad(layer)
                                        or _wants_grad((args, kwargs))):
            return layer(*args, **kwargs)
        if self._child_sf is None:
            self._child_sf = {}
        patched = []
        try:
            for name, child in _sublayers(layer):
                if "forward" in child.__dict__:
                    continue  # already patched (shared sublayer)
                sf = self._child_sf.get(name)
                if sf is None:
                    sf = StaticFunction(child, backend=self._backend)
                    self._child_sf[name] = sf
                child.forward = _child_compiled_forward(child, sf)
                patched.append(child)
            return layer(*args, **kwargs)
        finally:
            for child in patched:
                child.__dict__.pop("forward", None)

    def _positionalize(self, tensor_args, kwargs):
        """Move keyword-passed arrays into their positional slots by the
        function's signature while the slots stay contiguous (:286), so
        spec validation and the cache key see them as the trace does."""
        if not kwargs:
            return kwargs
        try:
            params = list(_inspect.signature(self._fn).parameters.values())
        except (TypeError, ValueError):
            return kwargs
        kwargs = dict(kwargs)
        for p in params[len(tensor_args):]:
            if (p.kind != p.POSITIONAL_OR_KEYWORD or p.name not in kwargs
                    or not _is_array(kwargs[p.name])):
                break
            tensor_args.append(kwargs.pop(p.name))
        return kwargs

    def __call__(self, *args, **kwargs):
        tensor_args = list(args)
        kwargs = self._positionalize(tensor_args, kwargs)
        # the positionalized call is the call from here on: keyword
        # tensors are traced by name, as graph inputs
        args = tuple(tensor_args)
        self._validate_input_spec(tensor_args)
        sig = _sig_of(tensor_args, kwargs)
        pinned = self._eager_sigs.get(sig)
        if pinned is not None:
            if (pinned + 1 < self._RETRY_AFTER
                    or self._retry_counts.get(sig, 0) >= self._MAX_RETRIES):
                if pinned + 1 < self._RETRY_AFTER:
                    self._eager_sigs[sig] = pinned + 1
                return self._fallback_call(args, kwargs)
            # the branch may have changed since the pin: retry the graph
            del self._eager_sigs[sig]
            self._retry_counts[sig] = self._retry_counts.get(sig, 0) + 1
        entry = self._cache.get(sig)
        if entry is None:
            entry = self._compile()
            self._cache[sig] = entry
            self._maybe_lint_first_compile(args, kwargs)
        try:
            return entry(*args, **kwargs)
        except _break_errors() as exc:
            self._eager_sigs[sig] = 0
            return self._graph_break(exc, args, kwargs)


def _child_compiled_forward(child, sf):
    """The instance-level forward a sublayer gets during its parent's
    eager (graph-broken) call (:403): an eager call goes through the
    sublayer's own StaticFunction, with the override lifted so that its
    trace reaches the real forward; a call inside an enclosing trace
    (``torch.compiler.is_compiling()``, where the JAX package asks
    ``_under_trace``, :392) inlines the real forward into that graph."""
    def wrapper(*a, **kw):
        if torch.compiler.is_compiling():
            return type(child).forward(child, *a, **kw)
        del child.forward
        try:
            return sf(*a, **kw)
        finally:
            child.forward = wrapper
    return wrapper


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Compile a function or a layer's forward (decorator or wrapper;
    ``paddle.jit.to_static``, :424): a ``StaticFunction``. ``backend``
    names the Dynamo backend (default Inductor)."""
    def wrap_fn(fn):
        return StaticFunction(fn, input_spec, build_strategy, backend)
    if function is None:
        return wrap_fn
    return wrap_fn(function)


def not_to_static(fn=None):
    """Mark a function to stay eager (:433): returned as it is."""
    if fn is None:
        return lambda f: f
    return fn


def enable_to_static(flag=True):
    """A no-op, as in the JAX package (:439)."""


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
        self._opt_state = self._init_opt_state()

    def _init_opt_state(self):
        return self._opt.init_state_pytree(self._params)

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
        loss, names, grads = self._raw_loss_and_grads(inputs, labels)
        clip = self._opt._grad_clip
        if clip is not None:
            grads = clip.clip_grads(grads)
        return loss, dict(zip(names, grads))

    def _raw_loss_and_grads(self, inputs, labels):
        """(loss, parameter names, their unclipped gradients)."""
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
        return loss, names, grads

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
