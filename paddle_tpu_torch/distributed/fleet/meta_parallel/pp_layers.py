"""PipelineLayer: a pipeline model's description and its segmentation
(counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
pp_layers.py``; reference parallel_layers/pp_layers.py:258, LayerDesc
:57, SharedLayerDesc :77).

The model is a list of items: ``torch.nn.Module``s, ``LayerDesc``s
(built here), ``SharedLayerDesc``s (one module for every item of the
same key: a tied embedding and head) and plain callables. Each module is
registered under its item index (``"0.weight"``, ``"1.self_attn...."``),
as the JAX ``PipelineLayer`` names them, so ``bridge.pipe_state_from_
numpy`` maps one set of weights onto the other.

The whole model is built on every rank, from one seed (so a pipeline
and the sequential model draw the same weights); ``PipelineParallel``
then keeps only this rank's stage. ``forward`` is the plain sequential
run. Segmentation (``_segment``) is the JAX package's: "uniform" by item
count, "layer:Class" (a boundary before the chunks of the Class items)
or an explicit list of stage sizes; ``pipelinable_run`` finds the
longest run of same-class modules of the same parameter names (the
blocks the schedule chunks evenly over the stages).

``allreduce_shared_weight_gradients`` sums each shared weight's gradient
over the stages that hold it (the first and the last, for a tied
embedding), through the groups ``PipelineParallel`` makes; on a whole
model (no pipeline) there is nothing to sum.

Divergence: items are torch modules or callables; a surface ``Layer``
(``paddle_tpu_torch.nn``, not a torch module) is refused: the port's
models are torch modules.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ... import mesh as mesh_mod


def _check_item(x):
    from ....nn.layer.layers import Layer
    if isinstance(x, Layer) or (isinstance(x, type) and issubclass(x, Layer)):
        raise TypeError(
            "PipelineLayer items are torch.nn.Modules or callables; a "
            "surface Layer is not a torch module")


class LayerDesc:
    """Lazy description of one pipeline item: ``layer_func(*inputs,
    **kwargs)``, a torch module class or a callable returning a module."""

    def __init__(self, layer_func: Callable, *inputs, **kwargs):
        if isinstance(layer_func, type):
            _check_item(layer_func)
            if not issubclass(layer_func, nn.Module):
                raise TypeError("LayerDesc expects a torch.nn.Module "
                                "subclass")
        elif not callable(layer_func):
            raise TypeError("LayerDesc expects a Module subclass or callable")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({getattr(self.layer_func, '__name__', '?')})"


class SharedLayerDesc(LayerDesc):
    """An item whose module is shared with every other item of the same
    ``key`` (a tied embedding and output head); ``forward_func(layer,
    x)`` is how this occurrence applies it. The stages holding it sum
    its ``shared_weight_attr`` gradient
    (``allreduce_shared_weight_gradients``)."""

    def __init__(self, key, layer_func, *inputs, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def item_module(item):
    """The module of an item ((module, forward_func) for a shared one;
    None for a plain callable)."""
    lyr = item[0] if isinstance(item, tuple) else item
    return lyr if isinstance(lyr, nn.Module) else None


def apply_item(item, x):
    if isinstance(item, tuple):          # (shared module, forward_func)
        lyr, ffn = item
        return ffn(lyr, x) if ffn is not None else lyr(x)
    return item(x)


class PipelineLayer(nn.Module):
    """A sequence of items with stage segmentation.

    Args (reference-shaped):
        layers: torch modules, LayerDescs, SharedLayerDescs, callables.
        num_stages: the pp degree (default: the mesh's 'pp' degree).
        loss_fn: the loss, ``loss_fn(output, labels)``.
        seg_method: "uniform" | "layer:ClassName" | a list of stage sizes.
        recompute_interval: > 0 recomputes each pipelined chunk's
            activations in its backward.
        num_virtual_pipeline_stages: chunks a stage (the interleaved
            schedule).
    """

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method="uniform",
                 recompute_interval: int = 0, recompute_ctx=None,
                 num_virtual_pipeline_stages: Optional[int] = None, **kw):
        super().__init__()
        if num_stages is None:
            num_stages = max(mesh_mod.axis_degree("pp"), 1)
        self._num_stages = int(num_stages)
        # the loss is not a part of the model (its state dict, a stage)
        self.__dict__["_loss_fn"] = loss_fn
        self._seg_method = seg_method
        self._recompute_interval = int(recompute_interval)
        self._num_virtual_stages = int(num_virtual_pipeline_stages or 1)
        self._shared_layers: Dict[Any, nn.Module] = {}
        self._shared_attrs: Dict[Any, str] = {}
        # {key: (group, holds)} set by PipelineParallel
        self._shared_comm: Dict[Any, Any] = {}

        built: List[Any] = []
        for desc in layers:
            _check_item(desc)
            if isinstance(desc, SharedLayerDesc):
                if desc.layer_name not in self._shared_layers:
                    self._shared_layers[desc.layer_name] = desc.build_layer()
                    self._shared_attrs[desc.layer_name] = \
                        desc.shared_weight_attr
                built.append((self._shared_layers[desc.layer_name],
                              desc.forward_func))
            elif isinstance(desc, LayerDesc):
                lyr = desc.build_layer()
                _check_item(lyr)
                built.append(lyr)
            else:
                built.append(desc)

        self._items: List[Any] = built
        for i, item in enumerate(built):
            lyr = item_module(item)
            if lyr is not None and not any(lyr is m for m in
                                           self._modules.values()):
                self.add_module(str(i), lyr)
        self._stage_bounds = self._segment()

    # -- segmentation --------------------------------------------------------
    def _segment(self) -> List[int]:
        n, s = len(self._items), self._num_stages
        if n < s:
            raise ValueError(f"{n} layers cannot fill {s} stages")
        method = self._seg_method
        if isinstance(method, (list, tuple)):
            sizes = list(method)
            if sum(sizes) != n or len(sizes) != s:
                raise ValueError("explicit segment sizes must cover layers")
            bounds = [0]
            for sz in sizes:
                bounds.append(bounds[-1] + sz)
            return bounds
        if isinstance(method, str) and method.startswith("layer:"):
            cls_name = method[len("layer:"):]
            marks = [i for i, it in enumerate(self._items)
                     if type(it[0] if isinstance(it, tuple) else it).__name__
                     == cls_name]
            if len(marks) < s:
                raise ValueError(
                    f"only {len(marks)} '{cls_name}' layers for {s} stages")
            per = len(marks) // s
            rem = len(marks) % s
            bounds = [0]
            idx = 0
            for st in range(s - 1):
                idx += per + (1 if st < rem else 0)
                bounds.append(marks[idx])
            bounds.append(n)
            return bounds
        per, rem = divmod(n, s)
        bounds = [0]
        for st in range(s):
            bounds.append(bounds[-1] + per + (1 if st < rem else 0))
        return bounds

    @property
    def segment_parts(self) -> List[int]:
        return list(self._stage_bounds)

    def stage_items(self, stage: int) -> List[Any]:
        lo, hi = self._stage_bounds[stage], self._stage_bounds[stage + 1]
        return self._items[lo:hi]

    def get_num_stages(self) -> int:
        return self._num_stages

    def item_prefix(self, item) -> Optional[str]:
        """The name an item's module is registered under."""
        lyr = item_module(item)
        for name, m in self._modules.items():
            if m is lyr:
                return name
        return None

    # -- execution -----------------------------------------------------------
    _apply = staticmethod(apply_item)

    def forward(self, x):
        for item in self._items:
            x = apply_item(item, x)
        return x

    @torch.no_grad()
    def allreduce_shared_weight_gradients(self):
        """Sum each shared weight's gradient over the stages holding it."""
        from ...communication import collectives as C
        for key, (group, holds) in self._shared_comm.items():
            if not holds or group is None or group.nranks <= 1:
                continue
            w = getattr(self._shared_layers[key], self._shared_attrs[key])
            if w.grad is None:
                w.grad = torch.zeros_like(w)
            C.all_reduce(w.grad, group=group)

    def pipelinable_run(self):
        """The longest contiguous run of same-class module items with the
        same parameter names: (start, end) item indices."""
        items = self._items
        best = (0, 0)
        i = 0
        while i < len(items):
            it = items[i]
            if not isinstance(it, nn.Module):
                i += 1
                continue
            names_i = sorted(n for n, _ in it.named_parameters())
            j = i + 1
            while j < len(items):
                jt = items[j]
                if not isinstance(jt, nn.Module) or type(jt) is not type(it):
                    break
                if sorted(n for n, _ in jt.named_parameters()) != names_i:
                    break
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j if j > i + 1 else i + 1
        return best
