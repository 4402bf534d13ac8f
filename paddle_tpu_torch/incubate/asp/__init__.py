"""paddle.incubate.asp, automatic structured (n:m) sparsity (counterpart
of ``paddle_tpu/incubate/asp/__init__.py``): ``prune_model`` multiplies
the weights of the supported layers (the surface ``nn.Linear`` and
``nn.Conv2D``, plus ``add_supported_layer``'s) by n:m magnitude masks
along their last axis (2:4 by default, ``_mask_2to4`` :56), and
``decorate`` re-applies the masks after every optimizer step. The masks
are dense, as in the JAX package; Hopper's sparse tensor cores are not
used."""
from __future__ import annotations

import weakref

import numpy as np
import torch

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers",
           "add_supported_layer"]

_excluded = set()
_supported_types = None
_masks = {}
_custom_prune = {}  # layer_type -> pruning_func(weight, n, m) -> mask


def _supported():
    global _supported_types
    if _supported_types is None:
        from ... import nn
        _supported_types = [nn.Linear, nn.Conv2D]
    return _supported_types


def add_supported_layer(layer_type, pruning_func=None):
    """Register a layer type for pruning; a ``pruning_func(weight ndarray,
    n, m) -> 0/1 mask`` replaces the n:m magnitude rule for it."""
    _supported().append(layer_type)
    if pruning_func is not None:
        _custom_prune[layer_type] = pruning_func


def set_excluded_layers(param_names, main_program=None):
    _excluded.update(param_names)


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def calculate_density(x) -> float:
    """The fraction of non-zeros."""
    from ...core.dispatch import unwrap
    a = unwrap(x)
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return float((a != 0).sum()) / max(a.size, 1)


def _mask_2to4(w: np.ndarray, n: int = 2, m: int = 4) -> np.ndarray:
    """The n:m magnitude mask along the last axis: in each group of m, the
    n largest |w| kept (numpy's argsort order, as in the JAX package)."""
    flat = w.reshape(-1, w.shape[-1])
    cols = flat.shape[1]
    pad = (-cols) % m
    if pad:
        flat = np.pad(flat, [(0, 0), (0, pad)])
    groups = flat.reshape(flat.shape[0], -1, m)
    order = np.argsort(-np.abs(groups), axis=-1)
    mask = np.zeros_like(groups)
    np.put_along_axis(mask, order[..., :n], 1.0, axis=-1)
    return mask.reshape(flat.shape)[:, :cols].reshape(w.shape)


@torch.no_grad()
def _apply(leaf, mask):
    leaf.mul_(torch.as_tensor(mask, dtype=leaf.dtype, device=leaf.device))


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Apply n:m magnitude masks to the supported layers' weights (in
    place). Returns {parameter name: mask}."""
    out = {}
    for name, sub in model.named_sublayers(include_self=True):
        if not isinstance(sub, tuple(_supported())):
            continue
        w = getattr(sub, "weight", None)
        if w is None or w.name in _excluded or len(w.shape) < 2:
            continue
        custom = next((f for t, f in _custom_prune.items()
                       if isinstance(sub, t)), None)
        w_np = w.numpy().astype(np.float32)
        if custom is not None:
            mask = np.asarray(custom(w_np, n, m), np.float32)
            if mask.shape != tuple(w.shape):
                raise ValueError(
                    f"pruning_func returned mask shape {mask.shape} "
                    f"for weight shape {tuple(w.shape)}")
        else:
            mask = _mask_2to4(w_np, n, m)
        _apply(w._data, mask)
        out[f"{name}.weight" if name else "weight"] = mask
        _masks[id(w._data)] = (weakref.ref(w._data), mask)
    return out


def decorate(optimizer):
    """Wrap ``optimizer.step`` to re-apply the pruning masks of its own
    parameters after each update (reference OptimizerWithSparsityGuarantee)."""
    own = {id(p) for p in optimizer._parameter_list}

    class _ASPOptimizer:
        def __init__(self, inner):
            self._inner = inner

        def step(self):
            self._inner.step()
            for key, (ref, mask) in list(_masks.items()):
                leaf = ref()
                if leaf is None:
                    del _masks[key]
                elif key in own:
                    _apply(leaf, mask)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    return _ASPOptimizer(optimizer)
