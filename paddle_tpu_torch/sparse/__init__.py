"""paddle.sparse of the port (counterpart of ``paddle_tpu/sparse``; the
reference's python/paddle/sparse: COO / CSR creation, unary / binary ops,
matmul and the sparse nn layers).

A ``SparseTensor`` holds its COO indices [sparse_ndim, nnz] (int64, read
back in the index dtype it was made with) and values [nnz, *dense_dims],
in the order given: duplicates are kept until ``coalesce``, as in the
JAX package's ``BCOO``. CSR is a format flag over the same storage, as
there. Products run on torch sparse tensors (``torch.sparse.mm``, cuSPARSE
on the card) and are differentiable in the dense operand and the values;
``to_dense`` is an accumulating ``index_put``. Where the JAX package
densifies (``divide``, ``slice``, ``sum``, ``pca_lowrank``, the nn
convolutions and pooling), so does the port, and nowhere else.
``to_sparse_coo`` ignores ``sparse_dim``, as ``BCOO.fromdense`` does:
every dimension is sparse, ``nnz`` counts nonzero elements, and the
indices read back as int32. ``multiply`` of two sparse tensors stores the
intersection of their patterns, where ``BCOO`` pads its result to
nnz(x) * nnz(y) entries: the dense values agree.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op, unwrap, wrap
from ..core.tensor import Tensor

__all__ = ["SparseTensor", "sparse_coo_tensor", "sparse_csr_tensor",
           "is_sparse", "to_dense", "to_sparse_coo", "matmul", "add",
           "multiply", "subtract", "divide", "relu", "abs", "sin", "tanh",
           "sqrt", "square", "neg", "asin", "asinh", "atan", "atanh", "sinh",
           "tan", "expm1", "log1p", "deg2rad", "rad2deg", "isnan", "pow",
           "cast", "coalesce", "is_same_shape", "reshape", "transpose",
           "slice", "sum", "mv", "addmm", "masked_matmul", "mask_as",
           "pca_lowrank"]


def _as_torch(x, device=None):
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


class SparseTensor:
    """A COO sparse tensor (the reference's SparseCooTensor)."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor, shape,
                 fmt: str = "coo", index_dtype=None):
        self._idx = indices.to(torch.int64)
        self._vals = values
        self._shape = tuple(int(s) for s in shape)
        self._fmt = fmt
        self._index_dtype = index_dtype or indices.dtype

    # -- paddle surface ------------------------------------------------------
    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return dtype_mod.from_torch(self._vals.dtype)

    def indices(self) -> Tensor:
        return wrap(self._idx.to(self._index_dtype))

    def values(self) -> Tensor:
        return wrap(self._vals)

    def nnz(self) -> int:
        return int(self._idx.shape[1])

    def to_dense(self) -> Tensor:
        return wrap(_dense(self))

    def is_sparse(self):
        return True

    def is_sparse_coo(self):
        return self._fmt == "coo"

    def is_sparse_csr(self):
        return self._fmt == "csr"

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"format={self._fmt})")

    def _with_values(self, vals):
        return SparseTensor(self._idx, vals, self._shape, self._fmt,
                            self._index_dtype)

    def _torch(self):
        """The torch sparse COO tensor of the same entries."""
        return torch.sparse_coo_tensor(self._idx, self._vals, self._shape,
                                       is_coalesced=False,
                                       check_invariants=False)

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, SparseTensor):
            return add(self, other)
        return run_op("sparse_add_dense", lambda v, o: _dense_of(
            self, v) + o, [wrap(self._vals), other])

    def __mul__(self, other):
        if isinstance(other, SparseTensor):
            return multiply(self, other)
        o = unwrap(other)
        if not isinstance(o, torch.Tensor) or o.dim() == 0:
            # a scalar scales the stored values: the result stays sparse
            return self._with_values(self._vals * o)
        return run_op("sparse_mul_dense", lambda v, d: _dense_of(
            self, v) * d, [wrap(self._vals), other])

    def matmul(self, other):
        return matmul(self, other)


def _dense_of(x: SparseTensor, vals: torch.Tensor) -> torch.Tensor:
    out = vals.new_zeros(x._shape)
    return out.index_put(tuple(x._idx), vals, accumulate=True)


def _dense(x: SparseTensor) -> torch.Tensor:
    return _dense_of(x, x._vals)


def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      place=None, stop_gradient=True):
    """A COO tensor from indices [sparse_ndim, nnz] and values [nnz, ...]
    (the shape, when not given, from the largest index of each
    dimension)."""
    vals = _as_torch(values)
    idx = _as_torch(indices, vals.device).to(vals.device)
    if dtype is not None:
        vals = vals.to(dtype_mod.dtype(dtype).torch_dtype)
    if shape is None:
        shape = tuple(int(i) + 1 for i in idx.amax(dim=1).tolist()) + \
            tuple(vals.shape[1:])
    return SparseTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    """A CSR tensor, stored as COO with the format kept."""
    vals = _as_torch(values)
    crows_t = _as_torch(crows, vals.device).to(vals.device)
    cols_t = _as_torch(cols, vals.device).to(vals.device)
    if dtype is not None:
        vals = vals.to(dtype_mod.dtype(dtype).torch_dtype)
    counts = crows_t[1:] - crows_t[:-1]
    rows = torch.repeat_interleave(
        torch.arange(len(counts), device=vals.device), counts.to(torch.int64))
    idx = torch.stack([rows.to(cols_t.dtype), cols_t])
    return SparseTensor(idx, vals, shape, fmt="csr")


def is_sparse(x):
    return isinstance(x, SparseTensor)


def to_dense(x: SparseTensor) -> Tensor:
    return x.to_dense()


def _from_dense(a: torch.Tensor) -> SparseTensor:
    idx = torch.nonzero(a).T                       # row-major order
    return SparseTensor(idx, a[tuple(idx)], a.shape,
                        index_dtype=torch.int32)


def to_sparse_coo(x, sparse_dim=None) -> SparseTensor:
    """Every nonzero element as an entry (``sparse_dim`` is ignored, as
    the JAX package's ``BCOO.fromdense`` ignores it)."""
    return _from_dense(unwrap(x))


def _need_2d(x, op):
    if len(x._shape) != 2 or x._vals.dim() != 1:
        raise NotImplementedError(f"sparse.{op}: a 2-d sparse matrix "
                                  f"with scalar values is supported")


def matmul(x: SparseTensor, y):
    """Sparse @ dense (or sparse @ sparse, the right one densified),
    differentiable in the dense operand and the values."""
    _need_2d(x, "matmul")
    other = y.to_dense() if isinstance(y, SparseTensor) else y

    def fn(v, d):
        s = torch.sparse_coo_tensor(x._idx, v, x._shape,
                                    check_invariants=False)
        if d.dim() == 1:
            return torch.sparse.mm(s, d[:, None])[:, 0]
        return torch.sparse.mm(s, d)
    return run_op("sparse_matmul", fn, [wrap(x._vals), other])


def add(x: SparseTensor, y: SparseTensor):
    """The entries of both, concatenated (duplicates summed by
    ``coalesce`` / ``to_dense``)."""
    return SparseTensor(torch.cat([x._idx, y._idx], dim=1),
                        torch.cat([x._vals, y._vals.to(x._vals.dtype)]),
                        x._shape, index_dtype=x._index_dtype)


def subtract(x: SparseTensor, y: SparseTensor, name=None):
    return SparseTensor(torch.cat([x._idx, y._idx], dim=1),
                        torch.cat([x._vals, -y._vals.to(x._vals.dtype)]),
                        x._shape, index_dtype=x._index_dtype)


def multiply(x: SparseTensor, y: SparseTensor):
    """The elementwise product: the entries where both are stored."""
    p = torch.mul(x._torch().coalesce(), y._torch().coalesce()).coalesce()
    return SparseTensor(p.indices(), p.values(), x._shape,
                        index_dtype=x._index_dtype)


def _unary(op_name, fn):
    def op(x: SparseTensor, name=None):
        return x._with_values(fn(x._vals))
    op.__name__ = op_name
    return op


relu = _unary("relu", torch.relu)
abs = _unary("abs", torch.abs)  # noqa: A001
sin = _unary("sin", torch.sin)
tanh = _unary("tanh", torch.tanh)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
neg = _unary("neg", torch.neg)
asin = _unary("asin", torch.asin)
asinh = _unary("asinh", torch.asinh)
atan = _unary("atan", torch.atan)
atanh = _unary("atanh", torch.atanh)
sinh = _unary("sinh", torch.sinh)
tan = _unary("tan", torch.tan)
expm1 = _unary("expm1", torch.expm1)
log1p = _unary("log1p", torch.log1p)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
isnan = _unary("isnan", torch.isnan)


def pow(x: SparseTensor, factor, name=None):  # noqa: A001
    """The stored values to the power ``factor``."""
    return x._with_values(torch.pow(x._vals, factor))


def cast(x: SparseTensor, index_dtype=None, value_dtype=None, name=None):
    """Cast the index and / or value dtypes."""
    vals = x._vals
    if value_dtype is not None:
        vals = vals.to(dtype_mod.dtype(value_dtype).torch_dtype)
    idt = dtype_mod.dtype(index_dtype).torch_dtype \
        if index_dtype is not None else x._index_dtype
    return SparseTensor(x._idx, vals, x._shape, x._fmt, idt)


def coalesce(x: SparseTensor, name=None):
    """Sort the entries and sum the duplicates."""
    c = x._torch().coalesce()
    return SparseTensor(c.indices(), c.values(), x._shape, x._fmt,
                        x._index_dtype)


def is_same_shape(x, y) -> bool:
    return list(x.shape) == list(y.shape)


def reshape(x: SparseTensor, shape, name=None):
    """The coalesced entries re-indexed in ``shape`` (row-major)."""
    if x._vals.dim() != 1:
        raise NotImplementedError("sparse.reshape of dense value dims")
    c = coalesce(x)
    new = [int(s) for s in shape]
    if -1 in new:
        known = int(np.prod([s for s in new if s != -1]))
        new[new.index(-1)] = int(np.prod(x._shape)) // known
    strides = torch.tensor(np.cumprod((list(x._shape[1:]) + [1])[::-1])[::-1]
                           .copy(), device=c._idx.device)
    lin = (c._idx * strides[:, None]).sum(dim=0)
    idx = []
    for s in reversed(new):
        idx.append(lin % s)
        lin = lin // s
    return SparseTensor(torch.stack(idx[::-1]), c._vals, new, x._fmt,
                        x._index_dtype)


def transpose(x: SparseTensor, perm, name=None):
    perm = [int(p) for p in perm]
    nsp = x._idx.shape[0]
    if sorted(perm[:nsp]) != list(range(nsp)) or \
            perm[nsp:] != list(range(nsp, len(perm))):
        raise NotImplementedError("sparse.transpose moves sparse dims "
                                  "among themselves only")
    return SparseTensor(x._idx[perm[:nsp]], x._vals,
                        [x._shape[p] for p in perm], x._fmt, x._index_dtype)


def slice(x: SparseTensor, axes, starts, ends, name=None):  # noqa: A001
    """Slice through the dense tensor, then re-sparsify (as JAX)."""
    idx = [builtins.slice(None)] * len(x.shape)
    for ax, st, en in zip(axes, starts, ends):
        ax = int(ax)
        size = x.shape[ax]
        st, en = int(st), int(en)
        st = st + size if st < 0 else st
        en = en + size if en < 0 else builtins.min(en, size)
        idx[ax] = builtins.slice(st, en)
    return _from_dense(_dense(x)[tuple(idx)])


def sum(x: SparseTensor, axis=None, dtype=None, keepdim=False,  # noqa: A001
        name=None):
    """Reduce-sum through the dense tensor; returns a SparseTensor."""
    dense = _dense(x)
    if axis is None:
        out = dense.sum()
        if keepdim:
            out = out.reshape([1] * dense.dim())
    else:
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        out = dense.sum(dim=ax, keepdim=keepdim)
    if dtype is not None:
        out = out.to(dtype_mod.dtype(dtype).torch_dtype)
    return _from_dense(out.reshape((1,) if out.dim() == 0 else out.shape))


def divide(x: SparseTensor, y: SparseTensor, name=None):
    """Elementwise divide through the dense tensors (the quotient is dense
    wherever y == 0)."""
    return _from_dense(_dense(x) / _dense(y))


def mv(x: SparseTensor, vec, name=None):
    """Sparse matrix x dense vector."""
    return matmul(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    """beta * input + alpha * (x @ y), x sparse or dense."""
    xy = matmul(x, y) if isinstance(x, SparseTensor) else \
        run_op("matmul", torch.matmul, [x, y])
    base = input.to_dense() if isinstance(input, SparseTensor) else input
    return run_op("addmm", lambda b, p: beta * b + alpha * p, [base, xy])


def masked_matmul(x, y, mask: SparseTensor, name=None):
    """(x @ y) at the mask's entries only (SDDMM): the needed rows and
    columns are gathered, the dense product never formed."""
    idx = mask._idx

    def fn(a, b):
        rows = a[idx[0], :]
        cols = b[:, idx[1]].T
        return torch.sum(rows * cols, dim=-1).to(a.dtype)
    vals = run_op("masked_matmul", fn, [x, y])._data
    return SparseTensor(idx, vals, mask._shape, mask._fmt, mask._index_dtype)


def mask_as(x, mask: SparseTensor, name=None):
    """Dense ``x`` sampled at the mask's entries."""
    idx = mask._idx
    vals = run_op("mask_as", lambda a: a[tuple(idx)], [x])._data
    return SparseTensor(idx, vals, mask._shape, mask._fmt, mask._index_dtype)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Low-rank PCA through the dense matrix's SVD: (U, S, V) of rank
    ``q``."""
    a = x.to_dense() if isinstance(x, SparseTensor) else x

    def fn(m):
        k = q if q is not None else builtins.min(6, m.shape[-2], m.shape[-1])
        if center:
            m = m - m.mean(dim=-2, keepdim=True)
        u, s, vh = torch.linalg.svd(m, full_matrices=False)
        return u[..., :k], s[..., :k], vh.transpose(-2, -1)[..., :k]
    return run_op("pca_lowrank", fn, [a])


from . import creation  # noqa: E402,F401
from . import nn  # noqa: E402,F401
