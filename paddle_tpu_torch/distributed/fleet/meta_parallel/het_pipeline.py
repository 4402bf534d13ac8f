"""Heterogeneous pipeline stages (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/het_pipeline.py``;
reference parallel_layers/pp_layers.py:114-119: custom ``seg_method``
bounds, non-uniform layer lists).

The JAX package runs one scan body on every pp device, so its stages
must share shapes: it flattens each stage's parameters into one padded
[S, Pmax] vector and its activations into [mb, Fmax] (``build_het_state``,
``make_het_block_fn``). That is an artefact of one SPMD program and is
not copied: in the port each pp rank runs its own stage, so a stage of
other layers, other parameter shapes and another output shape is native
(``PipelineParallel`` places the items by the explicit bounds and the
runtime sends each boundary's own shape and dtype before its first
message).

What stays: ``boundary_shapes``, the S+1 activation shapes of a
segmentation (traced on fake tensors, no compute), and the refusals of
the JAX package (``PipelineParallel``): ZBH1 and the MPMD modes with
non-uniform bounds raise with its messages.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .pp_layers import apply_item


def boundary_shapes(layers, bounds: Sequence[int], x_shape,
                    x_dtype=torch.float32) -> List[tuple]:
    """The activation shape at each of the S+1 stage boundaries of
    ``layers`` (a PipelineLayer) cut at ``bounds``, for an input of
    ``x_shape`` / ``x_dtype``: a trace on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shapes = [tuple(x_shape)]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
            torch.no_grad():
        x = mode.from_tensor(torch.empty(tuple(x_shape), dtype=x_dtype))
        for s in range(len(bounds) - 1):
            for item in layers._items[bounds[s]:bounds[s + 1]]:
                x = apply_item(item, x)
            shapes.append(tuple(x.shape))
    return shapes
