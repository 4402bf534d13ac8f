"""nn.Layer, the module base class (counterpart of ``paddle_tpu/nn/layer/layers.py``).

Parameters, sublayers and buffers register by ``__setattr__``;
``state_dict`` names them structurally, as the JAX ``Layer`` does
(``layers.0.self_attn.q_proj.weight``). A Layer is not a
``torch.nn.Module``: its parameters are surface ``Parameter``s, each
wrapping a leaf torch tensor. Moving or casting a Layer (``to``,
``astype``, ``float``, ...) and loading a state dict rewrite those
leaves in place, so an optimizer made before still holds them.
"""
from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch

from ...core import dtype as dtype_mod
from ...core import place as place_mod
from ...core.tensor import Tensor
from ...framework.param_attr import Parameter, ParamAttr
from .. import initializer as init_mod


class HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer:
    """Base class for all neural network layers."""

    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = dtype
        self._name_scope = name_scope or self.__class__.__name__.lower()
        self._parameters = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0

    # -- attribute registration ---------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "super().__init__() must run before assigning Parameters")
            for reg in (layers, buffers):
                if reg is not None:
                    reg.pop(name, None)
            params[name] = value
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError(
                    "super().__init__() must run before assigning sublayers")
            for reg in (params, buffers):
                if reg is not None:
                    reg.pop(name, None)
            layers[name] = value
            self.__dict__.pop(name, None)
        elif buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
            else:
                raise TypeError(
                    f"buffer {name} can only be reassigned a Tensor/None")
        else:
            if params is not None and name in params:
                if value is None:
                    params.pop(name)
                    object.__setattr__(self, name, None)
                    return
                raise TypeError(
                    f"{name} is a registered Parameter; assign a Parameter "
                    "or use add_parameter")
            if layers is not None and name in layers and value is None:
                layers.pop(name)
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for reg_name in ("_parameters", "_sub_layers", "_buffers"):
            reg = self.__dict__.get(reg_name)
            if reg is not None and name in reg:
                return reg[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for reg_name in ("_parameters", "_sub_layers", "_buffers"):
            reg = self.__dict__.get(reg_name)
            if reg is not None and name in reg:
                del reg[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        extra = list(self._parameters) + list(self._sub_layers) + \
            list(self._buffers)
        return sorted(set(super().__dir__() + extra))

    # -- parameter creation --------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A Parameter of ``shape`` on the current place, filled by the
        attr's initializer, else ``default_initializer``, else the global
        one, else zeros for a bias and XavierNormal for a weight (under
        ``LazyGuard``: zeros, the initializer kept for
        ``Parameter.initialize``)."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or self._dtype or "float32"
        initializer = attr.initializer or default_initializer
        if initializer is None:
            glob = (init_mod.global_bias_initializer() if is_bias
                    else init_mod.global_weight_initializer())
            if glob is not None:
                initializer = glob
            elif is_bias:
                initializer = init_mod.Constant(0.0)
            else:
                initializer = init_mod.XavierNormal()
        data = torch.zeros([int(s) for s in shape],
                           dtype=dtype_mod.to_torch(dtype),
                           device=place_mod.current_device())
        p = Parameter(data, trainable=attr.trainable, name=attr.name,
                      regularizer=attr.regularizer, need_clip=attr.need_clip,
                      learning_rate=attr.learning_rate)
        from ..initializer import lazy_init
        if lazy_init.in_lazy_mode():
            p._lazy_initializer = initializer
        else:
            initializer(p)
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter or None")
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        if not isinstance(sublayer, Layer):
            raise TypeError("add_sublayer expects a Layer")
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None and not isinstance(tensor, Tensor):
            raise TypeError("register_buffer expects a Tensor or None")
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        self.__dict__.pop(name, None)
        return tensor

    # -- traversal -----------------------------------------------------------
    def children(self) -> Iterator["Layer"]:
        for _, layer in self.named_children():
            yield layer

    def named_children(self):
        seen = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, layer in self.named_children():
            sub_prefix = prefix + ("." if prefix else "") + name
            yield from layer.named_sublayers(prefix=sub_prefix,
                                             include_self=True,
                                             layers_set=layers_set)

    def parameters(self, include_sublayers=True):
        return [p for _, p in
                self.named_parameters(include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        gen = self.named_sublayers(prefix=prefix, include_self=True) \
            if include_sublayers else [(prefix, self)]
        for lp, layer in gen:
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (lp + ("." if lp else "") + name, p)

    def buffers(self, include_sublayers=True):
        return [b for _, b in
                self.named_buffers(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        gen = self.named_sublayers(prefix=prefix, include_self=True) \
            if include_sublayers else [(prefix, self)]
        for lp, layer in gen:
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (lp + ("." if lp else "") + name, b)

    def apply(self, fn):
        for layer in self.children():
            layer.apply(fn)
        fn(self)
        return self

    # -- mode ----------------------------------------------------------------
    def train(self):
        self.training = True
        for layer in self.sublayers():
            layer.training = True
        return self

    def eval(self):
        self.training = False
        for layer in self.sublayers():
            layer.training = False
        return self

    # -- hooks ---------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -- execution -----------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} must implement forward()")

    def __call__(self, *inputs, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    # -- state dict ----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else \
            collections.OrderedDict()
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=prefix, include_sublayers=include_sublayers):
            dest[name] = p
        for name, b in self.named_buffers(
                prefix=prefix, include_sublayers=include_sublayers):
            owner = self
            for part in name[len(prefix) + 1 if prefix else 0:].split(
                    ".")[:-1]:
                owner = getattr(owner, part)
            if name.rsplit(".", 1)[-1] not in \
                    owner._non_persistable_buffer_names:
                dest[name] = b
        return dest

    to_static_state_dict = state_dict

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy surface Tensors, torch tensors or numpy arrays into the
        parameters and buffers by structured name (in place, in each
        target's dtype). Returns (missing_keys, unexpected_keys)."""
        own = self.state_dict()
        missing = []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            if isinstance(src, Tensor):
                src = src._data
            elif not isinstance(src, torch.Tensor):
                src = Tensor(np.asarray(src), place=target.place)._data
            if tuple(src.shape) != tuple(target._data.shape):
                raise ValueError(
                    f"shape mismatch for {name}: loading {tuple(src.shape)} "
                    f"into {tuple(target._data.shape)}")
            with torch.no_grad():
                target._data.copy_(src)
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict

    # -- dtype / device movement --------------------------------------------
    def _transform(self, fn):
        for t in list(self.parameters()) + list(self.buffers()):
            t._data.data = fn(t._data.data)
        return self

    def to(self, device=None, dtype=None, blocking=None):
        dev = None if device is None else \
            place_mod.parse_place(device).torch_device()
        want = None if dtype is None else dtype_mod.to_torch(dtype)

        def fn(a):
            if want is not None and a.is_floating_point():
                a = a.to(want)
            return a if dev is None else a.to(dev)
        return self._transform(fn)

    def astype(self, dtype):
        want = dtype_mod.to_torch(dtype)
        return self._transform(
            lambda a: a.to(want) if a.is_floating_point() else a)

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")

    # -- misc ----------------------------------------------------------------
    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_grad(set_to_zero)

    clear_grad = clear_gradients

    def full_name(self):
        return self._name_scope

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = []
        for name, layer in self.named_children():
            sub = repr(layer).split("\n")
            sub = [sub[0]] + ["  " + s for s in sub[1:]]
            lines.append(f"  ({name}): " + "\n".join(sub))
        return f"{type(self).__name__}({self.extra_repr()}" + \
            (")" if not lines else "\n" + "\n".join(lines) + "\n)")

    def __len__(self):
        return len(self._sub_layers)
