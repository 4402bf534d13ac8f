"""Tensor-parallel layers on local shards (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``).

The JAX package's layers hold GLOBAL weights that GSPMD partitions over
the ``mp`` axis. The port's hold this rank's shard, as the reference
does, and call the ``mp_ops`` collectives themselves; each sharded
parameter carries ``is_distributed = True``. Rank r of n holds:

- ``VocabParallelEmbedding``: rows [r V/n, (r+1) V/n) of the table;
  forward = shard lookup (other ids give zeros), then ``_mp_allreduce``;
- ``ColumnParallelLinear``: columns [r O/n, (r+1) O/n) of the weight and
  bias; forward = ``_c_identity`` on the input, the local product, then
  ``_c_concat`` when ``gather_output``;
- ``RowParallelLinear``: rows [r I/n, (r+1) I/n) of the weight, the whole
  bias; forward = ``_c_split`` of the input unless
  ``input_is_parallel``, the local product, ``_mp_allreduce``, the bias;
- ``ParallelCrossEntropy``: ``_c_softmax_with_cross_entropy`` on
  vocabulary-sharded logits.

With a model-parallel group of one each computes what its plain layer
computes. Weights are drawn at their GLOBAL shape and sliced (``shard``),
so that any mp degree builds the same global layer from one seed.

Two families share the layout rule and the ops:

- ``VocabParallelEmbedding`` / ``ColumnParallelLinear`` /
  ``RowParallelLinear`` / ``ParallelCrossEntropy`` are eager-surface
  ``Layer``s with Paddle's [in, out] weights, the names users import;
- the ``*Module`` classes are ``torch.nn.Module``s with torch's [out, in]
  weights (a column shard is then dim 0, a row shard dim 1), used by the
  port's models (``text/models/llama.py``, ``bert.py``) in place of
  ``torch.nn.Linear`` / ``Embedding``; ``shard(full)`` slices a global
  tensor to this rank's part, which ``reset_parameters`` and
  ``bridge.py`` use.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .....nn import functional as F
from .....nn.layer.layers import Layer
from .mp_ops import (_c_concat, _c_identity, _c_lookup_table, _c_split,
                     _c_softmax_with_cross_entropy, _mp_allreduce, _mp_group)


def _rank_degree(group):
    return (0, 1) if group is None else (group.rank, group.nranks)


def _part(full, dim, rank, n):
    size = full.shape[dim] // n
    return full.narrow(dim, rank * size, size)


def _check_divisible(what, size, n):
    if size % n:
        raise ValueError(f"{what} ({size}) must be divisible by the "
                         f"model-parallel degree ({n})")


# -- eager-surface Layers (Paddle's [in, out] layout) ----------------------

def _shard_param(layer, name, dim, group):
    """Replace ``layer.<name>`` (drawn at its global shape) by this rank's
    shard along ``dim``, marked ``is_distributed``."""
    p = getattr(layer, name)
    rank, n = _rank_degree(group)
    if n > 1:
        with torch.no_grad():
            local = _part(p._data, dim, rank, n).clone()
        p._data = local.requires_grad_(p._data.requires_grad)
    p.is_distributed = n > 1
    p._data.is_distributed = n > 1
    return p


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self._group = _mp_group(mp_group)
        self._rank, self._n = _rank_degree(self._group)
        _check_divisible("num_embeddings", num_embeddings, self._n)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.vocab_start_index = self._rank * (num_embeddings // self._n)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr)
        _shard_param(self, "weight", 0, self._group)

    def forward(self, x):
        if self._n == 1:
            return F.embedding(x, self.weight)
        out = _c_lookup_table(self.weight, x,
                              start_index=self.vocab_start_index)
        return _mp_allreduce(out, group=self._group)

    def extra_repr(self):
        return (f"num_embeddings={self._num_embeddings}, "
                f"embedding_dim={self._embedding_dim}, mp={self._n}")


class ColumnParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self._group = _mp_group(mp_group)
        self._rank, self._n = _rank_degree(self._group)
        _check_divisible("out_features", out_features, self._n)
        self._in_features, self._out_features = in_features, out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        _shard_param(self, "weight", 1, self._group)
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)
            _shard_param(self, "bias", 0, self._group)
        else:
            self.bias = None

    def forward(self, x):
        x = _c_identity(x, group=self._group)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = _c_concat(out, group=self._group)
        return out

    def extra_repr(self):
        return (f"in={self._in_features}, out={self._out_features}, "
                f"gather_output={self.gather_output}, mp={self._n}")


class RowParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self._group = _mp_group(mp_group)
        self._rank, self._n = _rank_degree(self._group)
        _check_divisible("in_features", in_features, self._n)
        self._in_features, self._out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        _shard_param(self, "weight", 0, self._group)
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = _c_split(x, group=self._group)
        out = _mp_allreduce(F.linear(x, self.weight), group=self._group)
        return out if self.bias is None else out + self.bias

    def extra_repr(self):
        return (f"in={self._in_features}, out={self._out_features}, "
                f"input_is_parallel={self.input_is_parallel}, mp={self._n}")


class ParallelCrossEntropy(Layer):
    """CE over vocabulary-sharded logits
    (``_c_softmax_with_cross_entropy``)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return _c_softmax_with_cross_entropy(
            input, label, group=self._group, ignore_index=self.ignore_index)


# -- torch.nn.Modules (torch's [out, in] layout), for the port's models ----

class _ShardedModule(nn.Module):
    """``shard(full)``: this rank's part of a global tensor of the
    parameter ``name`` (default the weight), by the module's rule."""

    _dims: dict = {}

    def shard(self, full: torch.Tensor, name: str = "weight") -> torch.Tensor:
        dim = self._dims.get(name)
        if dim is None or self.mp_degree == 1:
            return full
        return _part(full, dim, self.mp_rank, self.mp_degree)

    def global_shape(self, name: str = "weight"):
        shape = list(getattr(self, name).shape)
        dim = self._dims.get(name)
        if dim is not None:
            shape[dim] *= self.mp_degree
        return shape

    def _setup(self, group):
        self.group = _mp_group(group)
        self.mp_rank, self.mp_degree = _rank_degree(self.group)

    def _mark(self):
        for name in self._dims:
            p = getattr(self, name, None)
            if p is not None:
                p.is_distributed = self.mp_degree > 1


class VocabParallelEmbeddingModule(_ShardedModule):
    _dims = {"weight": 0}

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None, mp_group=None):
        super().__init__()
        self._setup(mp_group)
        _check_divisible("num_embeddings", num_embeddings, self.mp_degree)
        self.num_embeddings = num_embeddings
        self.vocab_start_index = self.mp_rank * (num_embeddings
                                                 // self.mp_degree)
        self.weight = nn.Parameter(torch.empty(
            num_embeddings // self.mp_degree, embedding_dim, device=device,
            dtype=dtype))
        self._mark()

    def forward(self, ids):
        if self.mp_degree == 1:
            return torch.nn.functional.embedding(ids, self.weight)
        out = _c_lookup_table(self.weight, ids,
                              start_index=self.vocab_start_index)
        return _mp_allreduce(out, group=self.group)


class ColumnParallelLinearModule(_ShardedModule):
    """``weight`` [out / n, in] (and ``bias`` [out / n]), a shard of a
    ``torch.nn.Linear``'s; ``split`` > 1 shards each of ``split`` equal
    column blocks on its own (BERT's fused qkv: each rank holds q, k and
    v of its heads). ``sync_input_grad=False``: the caller applies
    ``_c_identity`` once to an input that several column-parallel
    products read (LLaMA's q, k, v and gate, up), so that the backward
    all-reduces the input's gradient once, not once a product."""

    _dims = {"weight": 0, "bias": 0}

    def __init__(self, in_features, out_features, bias=False,
                 gather_output=False, device=None, dtype=None,
                 mp_group=None, split: int = 1,
                 sync_input_grad: bool = True):
        super().__init__()
        self._setup(mp_group)
        _check_divisible("out_features", out_features // split,
                         self.mp_degree)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.split = split
        self.sync_input_grad = sync_input_grad
        o = out_features // self.mp_degree
        self.weight = nn.Parameter(torch.empty(o, in_features, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.empty(o, device=device, dtype=dtype)) \
            if bias else None
        self._mark()

    def shard(self, full, name="weight"):
        if self.mp_degree == 1 or self.split == 1:
            return super().shard(full, name)
        blocks = full.chunk(self.split, dim=0)
        return torch.cat([_part(b, 0, self.mp_rank, self.mp_degree)
                          for b in blocks], dim=0)

    def forward(self, x):
        if self.sync_input_grad:
            x = _c_identity(x, group=self.group)
        out = torch.nn.functional.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = _c_concat(out, group=self.group)
        return out


class RowParallelLinearModule(_ShardedModule):
    """``weight`` [out, in / n] and a whole ``bias`` [out]."""

    _dims = {"weight": 1}

    def __init__(self, in_features, out_features, bias=False,
                 input_is_parallel=True, device=None, dtype=None,
                 mp_group=None):
        super().__init__()
        self._setup(mp_group)
        _check_divisible("in_features", in_features, self.mp_degree)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features // self.mp_degree, device=device,
            dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_features, device=device,
                                             dtype=dtype)) if bias else None
        self._mark()

    def forward(self, x):
        if not self.input_is_parallel:
            x = _c_split(x, group=self.group)
        out = _mp_allreduce(torch.nn.functional.linear(x, self.weight),
                            group=self.group)
        return out if self.bias is None else out + self.bias


def shard_of(module: Optional[nn.Module], name: str,
             full: torch.Tensor) -> torch.Tensor:
    """This rank's part of the global tensor ``full`` of ``module``'s
    parameter ``name`` (``full`` itself for a plain module)."""
    if isinstance(module, _ShardedModule):
        return module.shard(full, name)
    return full


def global_shape(module: nn.Module, name: str):
    if isinstance(module, _ShardedModule):
        return module.global_shape(name)
    return list(getattr(module, name).shape)
