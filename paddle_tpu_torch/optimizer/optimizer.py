"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

As in the JAX package, every optimizer states its math once as a
per-parameter rule ``_update(p, g, state, lr, wd)``, and two callers run
it: the eager ``step()``, over each parameter's ``.grad``, and
``apply_gradients_pytree``, over {name: tensor} dicts, which
``jit.TrainStep`` calls. Unlike the JAX rule, which returns new arrays,
the port's rule updates the parameter and its state tensors IN PLACE
(under ``torch.no_grad()``), so a step allocates no second copy of the
model or of its moments. Both callers hand the rule a list of
(parameter, gradient, state) items through ``_apply_updates``, which
Adam and AdamW override to take the fused CUDA update
(``kernels/fused_adam.py``).

The learning rate is a float or an ``lr.LRScheduler`` (``get_lr()``
reads the scheduler; ``set_lr`` raises under one). ``parameters`` may be
a list of tensors or of parameter groups ({"params": [...],
"learning_rate": scale, "weight_decay": wd}). The eager step scales the
lr by the group's ``learning_rate`` and by a parameter's
``optimize_attr["learning_rate"]`` (:117-118), decays with the group's
``weight_decay``, and keeps an f32 ``_master_weight`` of each bf16/fp16
parameter under ``multi_precision`` (:119-145). ``apply_gradients_pytree``
does what the JAX one does (:196-212): it ignores groups and
per-parameter rates, takes the lr it is given, and decays with
``self._weight_decay`` unless ``wd_mask`` says no.

``parameters`` (or a group's "params") may hold the eager surface's
``Parameter``s (``layer.parameters()``): each is unwrapped to its leaf
torch tensor and named by its ``.name``, as the JAX package names it. A
raw torch parameter carries no paddle name (``Tensor.name`` is
read-only), so raw parameters may come as (name, tensor) pairs, as
``model.named_parameters()`` gives them. ``state_dict`` uses the JAX
key format: ``<param name>.<slot>`` (the given name, else
``param_<index>``, as for the JAX package's unnamed parameters),
``@global_step`` and, under a scheduler, ``@lr_state``; AdamW's
``apply_decay_param_fun`` reads the same name.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..nn.clip import ClipGradBase

_HALF = (torch.float16, torch.bfloat16)


def _decay_value(wd) -> float:
    """A weight-decay coefficient from a float or a ``regularizer``
    object (counterpart of ``_decay_value``, :218)."""
    if wd is None:
        return 0.0
    if isinstance(wd, (int, float)):
        return float(wd)
    return float(getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        from .lr import LRScheduler
        if parameters is None:
            raise ValueError(
                "parameters is required (pass model.parameters())")
        #: id(param) -> the name it was given as a (name, tensor) pair
        self._names: Dict[int, str] = {}
        self._parameter_list = self._unpack(parameters)
        self._param_groups: List[dict] = []
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            groups = self._parameter_list
            self._parameter_list = []
            for g in groups:
                self._add_param_group(dict(g))
        else:
            self._param_groups = [{"params": self._parameter_list,
                                   "learning_rate": 1.0,
                                   "weight_decay": weight_decay}]
        self._learning_rate = learning_rate
        self._lr_scheduler = learning_rate if isinstance(
            learning_rate, LRScheduler) else None
        self.regularization = weight_decay
        self._weight_decay = weight_decay
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(
                "grad_clip must be a paddle_tpu_torch.nn.Clip* object")
        self._grad_clip = grad_clip
        #: f32 master weights for bf16/fp16 parameters in the eager step
        #: (Adam and AdamW switch it on with ``multi_precision=True``)
        self._multi_precision = False
        #: eager-step state: {id(param): {slot: tensor}}
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    def _unpack(self, params) -> list:
        """The torch tensors of ``params``, recording the names of (name,
        tensor) pairs and of named surface Parameters (group dicts pass
        through)."""
        from ..core.tensor import Tensor
        out = []
        for p in params:
            if isinstance(p, tuple) and len(p) == 2 and isinstance(p[0],
                                                                   str):
                self._names[id(p[1])] = p[0]
                p = p[1]
            elif isinstance(p, Tensor):
                if p.name:
                    self._names[id(p._data)] = p.name
                attr = getattr(p, "optimize_attr", None)
                p = p._data
                if attr is not None:
                    # the per-parameter lr the eager step reads
                    p.optimize_attr = attr
            out.append(p)
        return out

    def _name_of(self, p) -> Optional[str]:
        """The name a parameter was given (None when it came unnamed)."""
        return self._names.get(id(p))

    def _param_name(self, p, index: int) -> str:
        return self._name_of(p) or f"param_{index}"

    def _add_param_group(self, group):
        params = self._unpack(group["params"])
        group["params"] = params
        group.setdefault("learning_rate", 1.0)
        # as in the JAX package, a group built in __init__ finds no
        # _weight_decay yet and keeps None: the rule then falls back to
        # the optimizer's own weight_decay
        group.setdefault("weight_decay", self.__dict__.get("_weight_decay"))
        self._parameter_list.extend(params)
        self._param_groups.append(group)

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return float(self._learning_rate)

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError(
                "can't set_lr when learning_rate is an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr_scheduler = scheduler

    # -- the rule (subclasses) ----------------------------------------------
    def _init_state(self, param) -> Dict[str, torch.Tensor]:
        """Per-parameter state (zeros), shaped after ``param``."""
        return {}

    def _update(self, p, g, state, lr, wd=None):
        """Update ``p`` and ``state`` in place from gradient ``g``."""
        raise NotImplementedError

    def _lr_tensor(self, lr, device):
        return torch.tensor(float(lr), dtype=torch.float32, device=device)

    def _apply_updates(self, items, lr: float, wd):
        """Run the rule over ``items``, a list of (tensor to update,
        gradient in its dtype, state, the model parameter's dtype), all at
        learning rate ``lr`` and decay ``wd``."""
        lr_t = None
        for p, g, state, _ in items:
            if lr_t is None or lr_t.device != p.device:
                lr_t = self._lr_tensor(lr, p.device)
            self._update(p, g, state, lr_t, wd)

    def _state_for(self, param):
        key = id(param)
        if key not in self._accumulators:
            self._accumulators[key] = self._init_state(param.detach())
        return self._accumulators[key]

    def _params_with_grads(self, params):
        """(params, grads) of ``params`` that have a gradient, clipped."""
        params = [p for p in params if p.requires_grad and p.grad is not None]
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_grads(grads)
        return params, grads

    # -- eager step ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Apply one update from each parameter's ``.grad`` (parameters
        without a gradient are skipped), group by group."""
        base_lr = self.get_lr()
        params, grads = self._params_with_grads(
            [p for g in self._param_groups for p in g["params"]])
        grad_of = {id(p): g for p, g in zip(params, grads)}
        # one _apply_updates call per (lr, decay): the fused update takes
        # one lr and one decay a launch
        batches: Dict[tuple, list] = {}
        masters = []
        for group in self._param_groups:
            lr = base_lr * group.get("learning_rate", 1.0)
            wd = group.get("weight_decay")
            for p in group["params"]:
                g = grad_of.get(id(p))
                if g is None:
                    continue
                attr = getattr(p, "optimize_attr", None)
                plr = lr * attr.get("learning_rate", 1.0) \
                    if attr is not None else lr
                if self._multi_precision and p.dtype in _HALF:
                    # update an f32 master; a state made before
                    # multi_precision was on gets its master lazily
                    state = self._accumulators.get(id(p))
                    if state is None:
                        master = p.detach().float()
                        state = self._init_state(master)
                        state["_master_weight"] = master
                        self._accumulators[id(p)] = state
                    elif "_master_weight" not in state:
                        state["_master_weight"] = p.detach().float()
                    target, g = state["_master_weight"], g.float()
                    masters.append((p, target))
                else:
                    state, target, g = self._state_for(p), p, g.to(p.dtype)
                batches.setdefault((plr, id(wd)), [plr, wd, []])[2].append(
                    (target, g, state, p.dtype))
        for plr, wd, items in batches.values():
            self._apply_updates(items, plr, wd)
        for p, master in masters:
            p.copy_(master)
        self._global_step += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` (a torch or a surface tensor), then ``step``."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- state dict ----------------------------------------------------------
    def state_dict(self):
        """{"<name>.<slot>": tensor (the live state), "@global_step": int,
        "@lr_state": {...} under a scheduler}."""
        sd = {}
        for i, p in enumerate(self._parameter_list):
            state = self._accumulators.get(id(p))
            if not state:
                continue
            for k, v in state.items():
                sd[f"{self._param_name(p, i)}.{k}"] = v
        sd["@global_step"] = self._global_step
        if self._lr_scheduler is not None:
            sd["@lr_state"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Load a ``state_dict`` (tensors or numpy arrays; each slot is
        copied onto its parameter's device, in the dtype given)."""
        self._global_step = int(state_dict.get("@global_step", 0))
        if self._lr_scheduler is not None and "@lr_state" in state_dict:
            self._lr_scheduler.set_state_dict(state_dict["@lr_state"])
        for i, p in enumerate(self._parameter_list):
            pname = self._param_name(p, i)
            state = self._state_for(p)
            for k in list(state.keys()):
                key = f"{pname}.{k}"
                if key in state_dict:
                    v = state_dict[key]
                    if not isinstance(v, torch.Tensor):
                        v = torch.from_numpy(np.array(v))
                    state[k] = v.to(device=p.device, copy=True)

    # -- the TrainStep path --------------------------------------------------
    def init_state_pytree(self, params: Dict[str, torch.Tensor]):
        """{name: param} -> {name: {slot: tensor}}"""
        return {name: self._init_state(p) for name, p in params.items()}

    @torch.no_grad()
    def apply_gradients_pytree(self, params: Dict[str, torch.Tensor],
                               grads: Dict[str, Optional[torch.Tensor]],
                               state, lr, wd_mask=None):
        """Whole-model update used by ``TrainStep``: every parameter and
        its state are updated in place at learning rate ``lr``.
        ``wd_mask`` maps name -> bool (False: no weight decay for that
        parameter; the rule then falls back to the optimizer's own, as the
        JAX rule does); absent, as ``TrainStep`` calls it, every parameter
        is decayed."""
        batches: Dict[int, tuple] = {}
        for name, p in params.items():
            g = grads[name]
            if g is None:
                continue
            wd = self._weight_decay
            if wd_mask is not None and not wd_mask.get(name, True):
                wd = None
            batches.setdefault(id(wd), (wd, []))[1].append(
                (p, g.to(p.dtype), state[name], p.dtype))
        for wd, items in batches.values():
            self._apply_updates(items, float(lr), wd)
