"""Model summary (counterpart of ``paddle_tpu/hapi/summary.py``).

With ``input_size`` (or a concrete ``input``) the network runs ONE
forward pass with forward-post hooks on every sublayer, so the table
carries real per-layer OUTPUT SHAPES — including nested container
outputs (tuples/lists/dicts of tensors print every leaf shape),
matching the reference summary's behavior. Without an input the table
degrades to the params-only view.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor


def _leaf_shapes(out):
    """Collect the shapes of every Tensor leaf in a (possibly nested)
    layer output."""
    if isinstance(out, Tensor):
        return [list(out.shape)]
    if isinstance(out, (list, tuple)):
        shapes = []
        for o in out:
            shapes.extend(_leaf_shapes(o))
        return shapes
    if isinstance(out, dict):
        shapes = []
        for o in out.values():
            shapes.extend(_leaf_shapes(o))
        return shapes
    return []


def _fmt_shapes(shapes):
    if not shapes:
        return "-"
    return ", ".join(str(s) for s in shapes)


def _build_inputs(input_size, dtypes):
    """input_size: one shape or a list of shapes; -1/None dims become 1."""
    from .. import to_tensor
    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], (list, tuple)):
        sizes = list(input_size)
    else:
        sizes = [input_size]
    if dtypes is None:
        dtypes = ["float32"] * len(sizes)
    elif isinstance(dtypes, str):
        dtypes = [dtypes] * len(sizes)
    ins = []
    for shape, dt in zip(sizes, dtypes):
        shape = [1 if (d is None or int(d) < 0) else int(d)
                 for d in shape]
        if "int" in str(dt):
            ins.append(to_tensor(np.zeros(shape, np.int64)))
        else:
            ins.append(to_tensor(np.zeros(shape, np.float32)))
    return ins


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table (output shape + params); returns
    {'total_params', 'trainable_params'}."""
    out_shapes = {}
    if input is not None or input_size is not None:
        ins = ([input] if isinstance(input, Tensor) else list(input)) \
            if input is not None else _build_inputs(input_size, dtypes)
        hooks = []
        for _, layer in net.named_sublayers(include_self=True):
            def mk(lyr):
                def hook(l, inputs, outputs):
                    out_shapes[id(lyr)] = _leaf_shapes(outputs)
                    return None   # observe only — never replace outputs
                return hook
            hooks.append(layer.register_forward_post_hook(mk(layer)))
        # save PER-LAYER training flags: a blanket net.train() on
        # restore would un-freeze deliberately eval()'d sublayers
        modes = [(lyr, lyr.training)
                 for _, lyr in net.named_sublayers(include_self=True)]
        try:
            net.eval()
            with torch.no_grad():
                net(*ins)
        finally:
            for lyr, was in modes:
                lyr.training = was
            for h in hooks:
                h.remove()

    rows = []
    total, trainable = 0, 0
    for name, layer in net.named_sublayers(include_self=True):
        own = [p for p in layer._parameters.values() if p is not None]
        n = int(sum(np.prod(p.shape) if p.shape else 1 for p in own))
        t = int(sum(np.prod(p.shape) if p.shape else 1
                    for p in own if not p.stop_gradient))
        shp = _fmt_shapes(out_shapes.get(id(layer), []))
        if n or id(layer) in out_shapes:
            rows.append((name or type(layer).__name__,
                         type(layer).__name__, shp, n))
        total += n
        trainable += t
    width = max([len(r[0]) for r in rows], default=10) + 2
    swidth = max([len(r[2]) for r in rows], default=12) + 2
    print(f"{'Layer':<{width}}{'Type':<24}"
          f"{'Output Shape':<{swidth}}{'Params':>12}")
    print("-" * (width + swidth + 36))
    for name, tname, shp, n in rows:
        print(f"{name:<{width}}{tname:<24}{shp:<{swidth}}{n:>12,}")
    print("-" * (width + swidth + 36))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
