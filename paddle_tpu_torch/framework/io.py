"""paddle.save / paddle.load (counterpart of ``paddle_tpu/framework/io.py``).

The JAX package's file format: a magic line, then a pickle in which every
tensor is a dict of numpy data ({"__tensor__": True, "data": array,
"stop_gradient": bool}; bfloat16 as {"__bf16__": True, "data": uint16
view}); a raw torch tensor is saved as a Tensor. No torch object is
pickled, so a state dict saved by either package loads in the other. A
loaded tensor lands on the current place.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core import place as place_mod
from ..core.tensor import Tensor

_BF16_TAG = "__bf16__"
_MAGIC = b"PTPU1\n"


def _to_serializable(obj):
    if isinstance(obj, (Tensor, torch.Tensor)):
        sg = obj.stop_gradient if isinstance(obj, Tensor) else \
            not obj.requires_grad
        t = (obj._data if isinstance(obj, Tensor) else obj).detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_BF16_TAG: True, "data": t.view(torch.int16).numpy().view(
                np.uint16), "stop_gradient": sg}
        return {"__tensor__": True, "data": t.numpy(), "stop_gradient": sg}
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


def _tensor(t: torch.Tensor, stop_gradient):
    out = Tensor._from_data(t.to(place_mod.current_device()))
    out.stop_gradient = stop_gradient
    return out


def _from_serializable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get(_BF16_TAG):
            raw = np.ascontiguousarray(obj["data"]).view(np.int16)
            t = torch.from_numpy(raw.copy()).view(torch.bfloat16)
            if return_numpy:
                return Tensor._from_data(t).numpy()
            return _tensor(t, obj.get("stop_gradient", True))
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            return _tensor(torch.from_numpy(np.array(obj["data"])),
                           obj.get("stop_gradient", True))
        return {k: _from_serializable(v, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    if hasattr(path, "write"):
        pickle.dump(_to_serializable(obj), path, protocol=protocol)
        return
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(_to_serializable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    if hasattr(path, "read"):
        return _from_serializable(pickle.load(path), return_numpy)
    with open(str(path), "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            f.seek(0)
        return _from_serializable(pickle.load(f), return_numpy)
