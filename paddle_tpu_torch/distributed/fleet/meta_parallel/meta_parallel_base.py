"""The meta-parallel wrapper base (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/meta_parallel_base.py``;
reference meta_parallel_base.py).

A wrapper holds the user's model in ``_layers`` (a ``torch.nn.Module``
or an eager-surface ``Layer``), prepares it once (``_prepare_for_model``:
the broadcasts of each wrapper) and delegates the rest: the forward,
the parameters and the state dict under the model's own names, train /
eval, and any other attribute."""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn


def is_distributed(t) -> bool:
    """Whether a parameter is a tensor-parallel shard: its
    ``is_distributed`` set True by the mp layers (a torch tensor's own
    ``is_distributed`` method is no mark)."""
    return getattr(t, "is_distributed", False) is True


def is_expert(t) -> bool:
    """Whether a parameter is an expert-parallel shard (an MoE layer's
    rows of experts over the ``ep`` group), marked by ``MoELayer``."""
    return getattr(t, "expert_parallel", False) is True


def check_sequence_split(model, group):
    """Refuse to split ``model``'s sequence over ``group`` (a sep group of
    n > 1) unless it was built for that split: one of its modules (LLaMA's
    attention) holds the sep group it was built with. A model built
    without it would attend within each rank's chunk."""
    modules = model.modules() if hasattr(model, "modules") \
        else model.sublayers(include_self=True)
    if not any(getattr(m, "sep_group", None) is not None
               for m in modules):
        raise ValueError(
            f"{type(model).__name__} was not built for a sequence split "
            f"over sep ({group.nranks} ranks): build it after "
            "fleet.init(sep_degree=...), from a model whose attention "
            "takes the ring")


def torch_params(model) -> List[Tuple[str, torch.Tensor, bool]]:
    """(name, the torch leaf tensor, is_distributed) of each parameter of
    a Module or a surface Layer (whose Parameters wrap their leaves)."""
    out = []
    for name, p in model.named_parameters():
        leaf = getattr(p, "_data", p)
        out.append((name, leaf, is_distributed(p) or is_distributed(leaf)))
    return out


def torch_buffers(model) -> List[torch.Tensor]:
    return [getattr(b, "_data", b) for _, b in model.named_buffers()
            if b is not None]


class MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg=None, strategy=None, **kwargs):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def __getattr__(self, item):
        try:
            return super().__getattr__(item)
        except AttributeError:
            if item == "_layers":
                raise
            return getattr(self._layers, item)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def parameters(self, *args, **kwargs):
        return self._layers.parameters(*args, **kwargs)

    def named_buffers(self, *args, **kwargs):
        return self._layers.named_buffers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def train(self, mode=True):
        super().train(mode)
        self._layers.train() if mode else self._layers.eval()
        return self

    def eval(self):
        return self.train(False)
