"""Shape / layout manipulation ops (counterpart of ``paddle_tpu/ops/manipulation.py``).

The JAX package's functional updates (``a.at[idx].set(v)``) become a
clone written in place, so the result is a new node of torch's graph and
the gradient flows to both the kept values and the written ones. Ops
with a data-dependent output shape (``masked_select``, ``nonzero``,
``unique``) sync with the host, as the JAX ones do.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op, run_op_nodiff, unwrap, wrap
from ..core.tensor import Tensor

builtins_slice = builtins.slice
builtins_abs = builtins.abs
builtins_min = builtins.min


def builtins_sum(it):
    tot = 0
    for v in it:
        tot += v
    return tot


def _ints(v):
    v = unwrap(v)
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (int, np.integer)):
        return int(v)
    return [int(unwrap(s)) for s in v]


def _rebind(x, out):
    """In-place rebinding: x adopts out's data and graph."""
    x._data = out._data
    x._sg = out._sg
    return x


def cast(x, dtype, name=None):
    want = dtype_mod.to_torch(dtype)
    a = unwrap(x)
    floating = (a.is_floating_point() or a.is_complex()) and (
        want.is_floating_point or want.is_complex)
    runner = run_op if floating else run_op_nodiff
    return runner("cast", lambda b: b.to(want), [x])


def reshape(x, shape, name=None):
    shp = _ints(shape)
    shp = [shp] if isinstance(shp, int) else shp
    return run_op("reshape", lambda a: torch.reshape(a, shp), [x])


def reshape_(x, shape, name=None):
    return _rebind(x, reshape(x, shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(a):
        if a.dim() == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis, stop_axis)
    return run_op("flatten", fn, [x])


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _rebind(x, flatten(x, start_axis, stop_axis))


def squeeze(x, axis=None, name=None):
    def fn(a):
        if axis is None:
            return torch.squeeze(a)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(ax % a.dim() for ax in axes if a.shape[ax % a.dim()] == 1)
        return torch.squeeze(a, axes) if axes else a
    return run_op("squeeze", fn, [x])


def squeeze_(x, axis=None, name=None):
    return _rebind(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    axes = _ints(axis)
    axes = axes if isinstance(axes, list) else [axes]

    def fn(a):
        out = a
        for ax in sorted(ax % (out.dim() + 1) if ax < 0 else ax
                         for ax in axes):
            out = torch.unsqueeze(out, ax)
        return out
    return run_op("unsqueeze", fn, [x])


def unsqueeze_(x, axis, name=None):
    return _rebind(x, unsqueeze(x, axis))


def transpose(x, perm, name=None):
    perm = _ints(perm)
    return run_op("transpose", lambda a: a.permute(perm), [x])


def t(x, name=None):
    return run_op("t", lambda a: a if a.dim() < 2 else a.transpose(-1, -2)
                  if a.dim() == 2 else a.permute(*range(a.dim() - 1, -1, -1)),
                  [x])


def moveaxis(x, source, destination, name=None):
    return run_op("moveaxis", lambda a: torch.movedim(a, source, destination),
                  [x])


def swapaxes(x, axis1, axis2, name=None):
    return run_op("swapaxes", lambda a: torch.swapaxes(a, axis1, axis2), [x])


def concat(x, axis=0, name=None):
    ax = int(unwrap(axis)) if not isinstance(axis, int) else axis
    return run_op("concat", lambda *arrs: torch.cat(arrs, dim=ax), list(x))


def stack(x, axis=0, name=None):
    return run_op("stack", lambda *arrs: torch.stack(arrs, dim=axis), list(x))


def hstack(x, name=None):
    return run_op("hstack", lambda *arrs: torch.hstack(arrs), list(x))


def vstack(x, name=None):
    return run_op("vstack", lambda *arrs: torch.vstack(arrs), list(x))


def dstack(x, name=None):
    return run_op("dstack", lambda *arrs: torch.dstack(arrs), list(x))


def row_stack(x, name=None):
    return vstack(x, name)


def column_stack(x, name=None):
    return run_op("column_stack", lambda *arrs: torch.column_stack(arrs),
                  list(x))


def split(x, num_or_sections, axis=0, name=None):
    ax = int(unwrap(axis)) if not isinstance(axis, int) else axis
    dim = unwrap(x).shape[ax]
    if isinstance(num_or_sections, int):
        if num_or_sections <= 0 or dim % num_or_sections != 0:
            raise ValueError(
                f"split: axis dim {dim} is not divisible by "
                f"num_or_sections {num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = _ints(num_or_sections)
        neg = [i for i, s in enumerate(sizes) if s == -1]
        if neg:
            sizes[neg[0]] = dim - builtins_sum(s for s in sizes if s != -1)
    return list(run_op("split", lambda a: tuple(torch.split(a, sizes, ax)),
                       [x]))


def chunk(x, chunks, axis=0, name=None):
    dim = unwrap(x).shape[axis]
    base = (dim + chunks - 1) // chunks
    sizes, left = [], dim
    while left > 0:
        sizes.append(builtins_min(base, left))
        left -= base
    return split(x, sizes, axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    a = unwrap(x)
    spec = num_or_indices if isinstance(num_or_indices, int) \
        else _ints(num_or_indices)
    sizes = [p.shape[0] for p in torch.tensor_split(
        torch.empty(a.shape[axis], device="meta"), spec)]
    return split(x, sizes, axis)


def unbind(input, axis=0, name=None):  # noqa: A002
    return list(run_op("unbind", lambda a: tuple(torch.unbind(a, axis)),
                       [input]))


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    return run_op("tile", lambda a: torch.tile(a, reps), [x])


def expand(x, shape, name=None):
    shp = _ints(shape)
    return run_op("expand", lambda a: a.expand(shp), [x])


def broadcast_to(x, shape, name=None):
    return expand(x, shape, name)


def expand_as(x, y, name=None):
    return expand(x, list(unwrap(y).shape), name)


def broadcast_tensors(inputs, name=None):
    shp = torch.broadcast_shapes(*[unwrap(i).shape for i in inputs])
    return [expand(i, list(shp)) for i in inputs]


def flip(x, axis, name=None):
    axes = _ints(axis)
    axes = [axes] if isinstance(axes, int) else axes
    return run_op("flip", lambda a: torch.flip(a, axes), [x])


def fliplr(x):
    return run_op("fliplr", torch.fliplr, [x])


def flipud(x):
    return run_op("flipud", torch.flipud, [x])


def roll(x, shifts, axis=None, name=None):
    return run_op("roll", lambda a: torch.roll(
        a, _ints(shifts), _ints(axis) if axis is not None else None), [x])


def gather(x, index, axis=0, name=None):
    ax = int(unwrap(axis)) if not isinstance(axis, int) else axis

    def fn(a, i):
        return torch.index_select(a, ax, i.reshape(-1)).reshape(
            a.shape[:ax] + i.shape + a.shape[ax + 1:]) if i.dim() != 1 \
            else torch.index_select(a, ax, i)
    return run_op("gather", fn, [x, index])


def gather_nd(x, index, name=None):
    def fn(a, idx):
        k = idx.shape[-1]
        return a[tuple(torch.movedim(idx, -1, 0))] if k > 0 else a
    return run_op("gather_nd", fn, [x, index])


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    def fn(a, idx):
        if broadcast:
            shp = list(a.shape)
            shp[axis] = idx.shape[axis]
            idx = idx.expand(shp)
        return torch.take_along_dim(a, idx, dim=axis)
    return run_op("take_along_axis", fn, [arr, indices])


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    def fn(a, idx, v):
        v = torch.as_tensor(v, dtype=a.dtype, device=a.device)
        v = v.expand(idx.shape) if v.shape != idx.shape else v
        if reduce == "assign":
            return a.scatter(axis, idx, v)
        red = {"add": "sum", "mean": "sum", "mul": "prod", "multiply": "prod",
               "amin": "amin", "amax": "amax"}[reduce]
        return a.scatter_reduce(axis, idx, v, red)
    return run_op("put_along_axis", fn, [arr, indices, values])


def _at_set(a, idx, v):
    out = a.clone()
    out[idx] = v
    return out


def _at_add(a, idx, v):
    return a.index_put(idx if isinstance(idx, tuple) else (idx,), v,
                       accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    def fn(a, idx, upd):
        if overwrite:
            return _at_set(a, idx, upd)
        return _at_add(_at_set(a, idx, torch.zeros((), dtype=a.dtype,
                                                   device=a.device)),
                       idx, upd)
    return run_op("scatter", fn, [x, index, updates])


def scatter_(x, index, updates, overwrite=True, name=None):
    return _rebind(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    return run_op("scatter_nd_add", lambda a, idx, upd: _at_add(
        a, tuple(torch.movedim(idx, -1, 0)), upd), [x, index, updates])


def scatter_nd(index, updates, shape, name=None):
    def fn(idx, upd):
        z = torch.zeros(tuple(_ints(shape)), dtype=upd.dtype,
                        device=upd.device)
        return _at_add(z, tuple(torch.movedim(idx, -1, 0)), upd)
    return run_op("scatter_nd", fn, [index, updates])


def index_select(x, index, axis=0, name=None):
    return run_op("index_select", lambda a, i: torch.index_select(a, axis, i),
                  [x, index])


def index_sample(x, index):
    return run_op("index_sample", lambda a, idx: torch.take_along_dim(
        a, idx, dim=1), [x, index])


def _axis_index(a, axis, i):
    idx = [builtins_slice(None)] * a.dim()
    idx[axis] = i
    return tuple(idx)


def index_add(x, index, axis, value, name=None):
    return run_op("index_add", lambda a, i, v: torch.index_add(a, axis, i, v),
                  [x, index, value])


def index_add_(x, index, axis, value, name=None):
    return _rebind(x, index_add(x, index, axis, value))


def index_put(x, indices, value, accumulate=False, name=None):
    def fn(a, v, *idx):
        return a.index_put(tuple(idx), v, accumulate=accumulate)
    return run_op("index_put", fn, [x, value] + list(indices))


def index_put_(x, indices, value, accumulate=False, name=None):
    return _rebind(x, index_put(x, indices, value, accumulate))


def index_fill(x, index, axis, value, name=None):
    return run_op("index_fill", lambda a, i: torch.index_fill(
        a, axis, i, value), [x, index])


def index_fill_(x, index, axis, value, name=None):
    return _rebind(x, index_fill(x, index, axis, value))


def masked_select(x, mask, name=None):
    """Not differentiable, as the JAX package's (a host-side select)."""
    return run_op_nodiff("masked_select", torch.masked_select, [x, mask])


def masked_fill(x, mask, value, name=None):
    v = unwrap(value)
    return run_op("masked_fill", lambda a, m: torch.where(
        m, torch.as_tensor(v, dtype=a.dtype, device=a.device), a), [x, mask])


def masked_fill_(x, mask, value, name=None):
    return _rebind(x, masked_fill(x, mask, value))


def masked_scatter(x, mask, value, name=None):
    """Not differentiable, as the JAX package's (a host-side write)."""
    return run_op_nodiff("masked_scatter", lambda a, m, v: a.masked_scatter(
        m, v.reshape(-1)[:int(m.sum())].to(a.dtype)), [x, mask, value])


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def fn(c, a, b):
        if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
            from .math import _pair
            a, b = _pair(a, b)
        return torch.where(c, a, b)
    return run_op("where", fn, [condition, x, y])


def where_(condition, x, y, name=None):
    return _rebind(x, where(condition, x, y))


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(unwrap(x))
    if as_tuple:
        return tuple(wrap(c) for c in nz.unbind(1))
    return wrap(nz)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    pad_list = _ints(pad)

    def fn(a):
        nd = a.dim()
        if len(pad_list) == 2 * nd:
            pairs = [(pad_list[2 * i], pad_list[2 * i + 1])
                     for i in range(nd)]
        else:
            # paddle: pad the last len(pad) // 2 dims, the last one first
            k = len(pad_list) // 2
            tail = [(pad_list[2 * i], pad_list[2 * i + 1]) for i in range(k)]
            pairs = [(0, 0)] * (nd - k) + tail[::-1]
            if data_format in ("NHWC", "NDHWC", "NLC") and nd > 2:
                pairs = ([(0, 0)] + pairs[2:] + [(0, 0)])[:nd]
        flat = [v for lo, hi in reversed(pairs) for v in (lo, hi)]
        tmode = {"constant": "constant", "reflect": "reflect",
                 "replicate": "replicate", "circular": "circular"}[mode]
        if tmode == "constant":
            return torch.nn.functional.pad(a, flat, value=value)
        # torch pads the trailing dims of a batched input in these modes
        lead = next((i for i, p in enumerate(pairs) if p != (0, 0)), nd)
        b = a.reshape((-1,) + a.shape[lead:]) if lead else a[None]
        out = torch.nn.functional.pad(b, [v for lo, hi in reversed(
            pairs[lead:]) for v in (lo, hi)], mode=tmode)
        return out.reshape(a.shape[:lead] + out.shape[1:]) if lead \
            else out[0]
    return run_op("pad", fn, [x])


def slice(input, axes, starts, ends):  # noqa: A001,A002
    axes_, starts_, ends_ = _ints(axes), _ints(starts), _ints(ends)

    def fn(a):
        idx = [builtins_slice(None)] * a.dim()
        for ax, st, en in zip(axes_, starts_, ends_):
            size = a.shape[ax]
            st2 = builtins.max(st + size, 0) if st < 0 else builtins_min(
                st, size)
            en2 = builtins.max(en + size, 0) if en < 0 else builtins_min(
                en, size)
            idx[ax] = builtins_slice(st2, builtins.max(en2, st2))
        return a[tuple(idx)]
    return run_op("slice", fn, [input])


def _consumed_dims(i):
    """Dims of the indexed tensor one index entry consumes."""
    if i is None or i is Ellipsis:
        return 0
    if isinstance(i, (torch.Tensor, np.ndarray)) and i.dtype in (
            torch.bool, np.bool_):
        return i.ndim
    return 1


def _positive_steps(idx, shape):
    """Rewrite the negative-step slices of an index as positive-step
    slices of the tensor flipped along their dims (torch slices take
    positive steps only). Returns (index, dims to flip); no dims when the
    index has no negative step. ``a[idx]`` equals
    ``a.flip(dims)[index]`` element for element, in the same order."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    if not builtins.any(isinstance(i, builtins_slice) and i.step is not None
                        and int(i.step) < 0 for i in items):
        return idx, []
    used = builtins_sum(_consumed_dims(i) for i in items)
    out, flips, d = [], [], 0
    for i in items:
        if i is Ellipsis:
            out.append(i)
            d += len(shape) - used
            continue
        if isinstance(i, builtins_slice) and i.step is not None \
                and int(i.step) < 0:
            n = int(shape[d])
            start, stop, step = i.indices(n)
            # element k of the flipped dim is element n-1-k of the original
            out.append(builtins_slice(n - 1 - start, n - 1 - stop, -step))
            flips.append(d)
        else:
            out.append(i)
        d += _consumed_dims(i)
    return tuple(out), flips


def _getitem_body(a, idx):
    pidx, flips = _positive_steps(idx, a.shape)
    return a.flip(flips)[pidx] if flips else a[idx]


def _setitem_body(a, idx, v):
    """``a`` with ``a[idx] = v`` written into a clone (a graph node)."""
    pidx, flips = _positive_steps(idx, a.shape)
    if not flips:
        return _at_set(a, idx, v)
    return _at_set(a.flip(flips), pidx, v).flip(flips)


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes_, st_, en_, sd_ = map(_ints, (axes, starts, ends, strides))

    def fn(a):
        idx = [builtins_slice(None)] * a.dim()
        for ax, s, e, d in zip(axes_, st_, en_, sd_):
            idx[ax] = builtins_slice(s, e, d)
        return _getitem_body(a, tuple(idx))
    return run_op("strided_slice", fn, [x])


def crop(x, shape=None, offsets=None, name=None):
    shp = _ints(shape)
    offs = _ints(offsets) if offsets is not None else [0] * len(shp)

    def fn(a):
        idx = tuple(builtins_slice(off, off + (a.shape[ax] - off
                                               if sz == -1 else sz))
                    for ax, (off, sz) in enumerate(zip(offs, shp)))
        return a[idx]
    return run_op("crop", fn, [x])


def as_strided(x, shape, stride, offset=0, name=None):
    return run_op("as_strided", lambda a: torch.as_strided(
        a.contiguous(), tuple(shape), tuple(stride), offset), [x])


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return wrap(unwrap(x).view(dtype_mod.to_torch(shape_or_dtype)))


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def unfold(x, axis, size, step, name=None):
    return run_op("unfold", lambda a: a.unfold(axis, size, step), [x])


def repeat_interleave(x, repeats, axis=None, name=None):
    return run_op("repeat_interleave", lambda a, *r: torch.repeat_interleave(
        a, r[0] if r else repeats, dim=axis),
        [x] + ([repeats] if isinstance(repeats, Tensor) else []))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    def fn(a):
        shard_size = (index_num + nshards - 1) // nshards
        lo, hi = shard_id * shard_size, (shard_id + 1) * shard_size
        return torch.where((a >= lo) & (a < hi), a - lo,
                           torch.full_like(a, ignore_value))
    return run_op_nodiff("shard_index", fn, [input])


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    a = Tensor._from_data(unwrap(x)).numpy()
    out = np.unique(a, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev = unwrap(x).device
    if not isinstance(out, tuple):
        return wrap(torch.as_tensor(out, device=dev))
    return tuple(wrap(torch.as_tensor(o, device=dev)) for o in out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a = unwrap(x)
    out = torch.unique_consecutive(a, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if isinstance(out, tuple):
        vals, *rest = out
        rest = [r.reshape(-1).to(torch.int64) for r in rest]
        return tuple(wrap(o) for o in [vals] + rest)
    return wrap(out)


def top_p_sampling(x, ps, threshold=None, seed=None):
    from ..core import random as random_mod
    a, p = unwrap(x), unwrap(ps)
    gen = torch.Generator(device=a.device).manual_seed(int(seed)) if seed \
        else random_mod.generator(a.device)
    sorted_probs, sorted_idx = torch.sort(a, dim=-1, descending=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = cum - sorted_probs <= p[..., None]
    masked = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    masked = masked / masked.sum(-1, keepdim=True)
    choice = torch.multinomial(masked.reshape(-1, masked.shape[-1]), 1,
                               generator=gen).reshape(masked.shape[:-1] + (1,))
    picked = torch.take_along_dim(sorted_idx, choice, dim=-1)
    return wrap(torch.take_along_dim(a, picked, dim=-1)), \
        wrap(picked.to(torch.int64))


def numel(x, name=None):
    a = unwrap(x)
    return wrap(torch.tensor(a.numel(), dtype=torch.int64, device=a.device))


def rank(x):
    a = unwrap(x)
    return wrap(torch.tensor(a.dim(), dtype=torch.int32, device=a.device))


def shape(x):
    a = unwrap(x)
    return wrap(torch.tensor(list(a.shape), dtype=torch.int32,
                             device=a.device))


def is_empty(x, name=None):
    a = unwrap(x)
    return wrap(torch.tensor(a.numel() == 0, device=a.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def is_complex(x):
    return unwrap(x).is_complex()


def is_integer(x):
    a = unwrap(x)
    return not (a.is_floating_point() or a.is_complex() or
                a.dtype == torch.bool)


def is_floating_point(x):
    return unwrap(x).is_floating_point()


def real(x, name=None):
    from . import math
    return math.real(x)


def imag(x, name=None):
    from . import math
    return math.imag(x)


def as_complex(x, name=None):
    return run_op("as_complex", lambda a: torch.view_as_complex(
        a.contiguous()), [x])


def as_real(x, name=None):
    return run_op("as_real", torch.view_as_real, [x])


def tolist(x):
    return x.tolist()


def tensordot(x, y, axes=2, name=None):
    ax = axes.tolist() if isinstance(axes, Tensor) else axes
    return run_op("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax),
                  [x, y])


def _atleast(op_name, fn, inputs):
    outs = [run_op(op_name, fn, [x]) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast("atleast_1d", torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast("atleast_2d", torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast("atleast_3d", torch.atleast_3d, inputs)


def unstack(x, axis=0, num=None, name=None):
    return list(run_op("unstack", lambda a: tuple(torch.unbind(a, axis)),
                       [x]))


def reverse(x, axis, name=None):
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return run_op("reverse", lambda a: torch.flip(a, ax), [x])


def split_with_num(x, num, axis=0, name=None):
    return split(x, int(num), axis=axis)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    return run_op("diag_embed", lambda a: torch.diag_embed(
        a, offset, dim1, dim2), [input])


def fill_(x, value):
    return x.fill_(value)


fill = fill_


def _diag_fill_indices(h, w, offset, wrap_):
    """(rows, cols) of the (offset) diagonal; ``wrap_`` continues the
    diagonal past the bottom of a tall matrix (reference semantics)."""
    rows, cols = [], []
    r = -offset if offset < 0 else 0
    c = offset if offset > 0 else 0
    while r < h and c < w:
        rows.append(r)
        cols.append(c)
        r += 1
        c += 1
        if wrap_ and r < h and c >= w:
            r += 1
            c = 0
    return rows, cols


def fill_diagonal(x, value, offset=0, wrap=False, name=None):  # noqa: A002
    def fn(a):
        rows, cols = _diag_fill_indices(a.shape[-2], a.shape[-1], offset,
                                        wrap)
        return _at_set(a, (Ellipsis, rows, cols), value)
    return run_op("fill_diagonal", fn, [x])


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):  # noqa: A002
    return _rebind(x, fill_diagonal(x, value, offset, wrap))


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    def fn(a, b):
        nd = a.dim()
        d1, d2 = dim1 % nd, dim2 % nd
        perm = [i for i in range(nd) if i not in (d1, d2)] + [d1, d2]
        ap = a.permute(perm)
        n = builtins_min(ap.shape[-2], ap.shape[-1])
        idx = np.arange(n)
        rows = idx + (-offset if offset < 0 else 0)
        cols = idx + (offset if offset > 0 else 0)
        keep = (rows < ap.shape[-2]) & (cols < ap.shape[-1])
        ap = _at_set(ap, (Ellipsis, rows[keep].tolist(),
                          cols[keep].tolist()), b.to(a.dtype))
        inv = [0] * nd
        for i, p in enumerate(perm):
            inv[p] = i
        return ap.permute(inv)
    return run_op("fill_diagonal_tensor", fn, [x, y])


def frame(x, frame_length, hop_length, axis=-1, name=None):
    def fn(a):
        last = axis in (-1, a.dim() - 1)
        a_m = a if last else torch.movedim(a, 0, -1)
        out = a_m.unfold(-1, frame_length, hop_length)  # [..., num, fl]
        if last:
            return out.transpose(-1, -2)
        return torch.movedim(torch.movedim(out, -2, 0), -1, 1)
    return run_op("frame", fn, [x])


def overlap_add_frames(frames, hop_length):
    """Sum the frames of ``frames`` [..., frame_length, num], frame i
    shifted by ``i * hop_length``, into [..., (num - 1) * hop + length]:
    one ``F.fold`` (no loop over frames)."""
    if frames.is_complex():
        return torch.complex(overlap_add_frames(frames.real, hop_length),
                             overlap_add_frames(frames.imag, hop_length))
    lead = frames.shape[:-2]
    frame_length, num = frames.shape[-2], frames.shape[-1]
    out_len = (num - 1) * hop_length + frame_length
    out = torch.nn.functional.fold(
        frames.reshape(-1, frame_length, num), output_size=(1, out_len),
        kernel_size=(1, frame_length), stride=(1, hop_length))
    return out.reshape(lead + (out_len,))


def overlap_add(x, hop_length, axis=-1, name=None):
    def fn(a):
        last = axis in (-1, a.dim() - 1)
        a_m = a if last else torch.movedim(torch.movedim(a, 0, -1), 0, -2)
        out = overlap_add_frames(a_m, hop_length)
        return out if last else torch.movedim(out, -1, 0)
    return run_op("overlap_add", fn, [x])


def repeat_interleave_with_tensor_index(x, repeats, axis=None, name=None):
    return run_op("repeat_interleave_with_tensor_index",
                  lambda a, r: torch.repeat_interleave(a, r, dim=axis),
                  [x, repeats])


def index_select_strided(x, index, axis=0, name=None):
    return index_select(x, index, axis)


def view_shape(x, shape=None, name=None):
    return reshape(x, shape)


def view_dtype(x, dtype, name=None):
    want = dtype_mod.to_torch(dtype)
    return run_op_nodiff("view_dtype", lambda a: a.view(want), [x])


def trans_layout(x, perm, name=None):
    return transpose(x, perm)


def assign_out_(x, output):
    output._data = unwrap(x)
    return output


def assign_value_(output, shape, dtype, values, name=None):
    output._data = torch.as_tensor(
        np.array(values).reshape(shape), dtype=dtype_mod.to_torch(dtype),
        device=output._data.device)
    return output


def block_diag(inputs, name=None):
    return run_op("block_diag", lambda *m: torch.block_diag(*m), list(inputs))


def cartesian_prod(x, name=None):
    return run_op("cartesian_prod", lambda *v: torch.cartesian_prod(*v),
                  list(x))


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return run_op("diagonal_scatter", lambda a, b: torch.diagonal_scatter(
        a, b.to(a.dtype), offset, axis1, axis2), [x, y])


def select_scatter(x, values, axis, index, name=None):
    return run_op("select_scatter", lambda a, v: torch.select_scatter(
        a, v.to(a.dtype), axis, index), [x, values])


def slice_scatter(x, value, axes=None, starts=None, ends=None, strides=None,
                  name=None):
    axes = [0] if axes is None else _ints(axes)
    axes = [axes] if isinstance(axes, int) else axes

    def fn(a, v):
        ss = [0] * len(axes) if starts is None else _ints(starts)
        ee = [a.shape[ax] for ax in axes] if ends is None else _ints(ends)
        tt = [1] * len(axes) if strides is None else _ints(strides)
        idx = [builtins_slice(None)] * a.dim()
        for ax, s, e, st in zip(axes, ss, ee, tt):
            idx[int(ax) % a.dim()] = builtins_slice(int(s), int(e), int(st))
        return _at_set(a, tuple(idx), v.to(a.dtype))
    return run_op("slice_scatter", fn, [x, value])


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0 if len(x.shape) == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    if len(x.shape) < 2:
        raise ValueError("vsplit expects a tensor with at least 2 dims, "
                         f"got {len(x.shape)}")
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    if len(x.shape) < 3:
        raise ValueError("dsplit expects a tensor with at least 3 dims, "
                         f"got {len(x.shape)}")
    return tensor_split(x, num_or_indices, axis=2)


def unflatten(x, axis, shape, name=None):
    shp = _ints(shape)
    shp = [shp] if isinstance(shp, int) else list(shp)
    return run_op("unflatten", lambda a: torch.unflatten(a, axis, shp), [x])
