"""Megatron-style sequence parallelism over the tensor-parallel group
(counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``;
reference fleet/utils/sequence_parallel_utils.py).

Between the tensor-parallel products the activations stay split along
the sequence (dim 1 of [batch, seq, hidden]) over the mp group: each
rank holds s / mp rows. The JAX package states that layout and lets
GSPMD place the collectives; the port's ranks hold their slices, so
every op is a collective with its own backward (``mp_ops``):

================================  ====================  ====================
op                                forward               backward
================================  ====================  ====================
``scatter`` / ``ScatterOp``       this rank's slice     all-gather
``all_gather`` / ``GatherOp``     all-gather            this rank's slice
``AllGatherOp``                   all-gather            reduce-scatter (sum)
``reduce_scatter`` /              reduce-scatter (sum)  all-gather
``ReduceScatterOp``
================================  ====================  ====================

``ColumnSequenceParallelLinear`` all-gathers its sequence-split input
(``AllGatherOp``: the product's ranks each hold a part of the input's
gradient) and multiplies by its column shard; ``RowSequenceParallelLinear``
multiplies its feature-split input by its row shard and reduce-scatters
the partial sums back to a sequence split, its bias added after. The
``*Module`` classes are the ``torch.nn.Module`` forms the port's models
use (torch's [out, in] weights, the layout of ``mp_layers``' modules),
the others the eager-surface ``Layer``s with Paddle's [in, out].

Parameters applied to sequence slices (the norms between the products,
a row-parallel bias) hold a part of their gradient on each mp rank:
``mark_as_sequence_parallel_parameter`` marks them, and their gradients
are summed over the mp group once, by ``DistributedTrainStep`` or
``HybridParallelOptimizer.step``
(``hybrid_parallel_optimizer.sum_sequence_parallel_grads``);
``register_sequence_parallel_allreduce_hooks`` registers nothing, as the
JAX package's hook, where GSPMD makes that sum.
"""
from __future__ import annotations

import torch

from ....nn import functional as F
from ....nn.layer.layers import Layer
from ...communication import collectives as C
from ..layers.mpu import mp_ops
from ..layers.mpu.mp_layers import (ColumnParallelLinearModule,
                                    RowParallelLinearModule, _check_divisible,
                                    _rank_degree, _shard_param)

_SEQ_DIM = 1


def scatter(x, group=None):
    """This rank's slice of the sequence dim; the backward all-gathers
    (reference ScatterOp)."""
    return mp_ops._apply("sp_scatter", mp_ops._Split, x, group, _SEQ_DIM)


def all_gather(x, group=None):
    """The sequence slices gathered; the backward keeps this rank's slice
    (reference GatherOp: the gathered tensor's consumers are replicated)."""
    return mp_ops._apply("sp_gather", mp_ops._Concat, x, group, _SEQ_DIM)


def reduce_scatter(x, group=None):
    """The ranks' partial sums reduced and split along the sequence; the
    backward all-gathers (reference ReduceScatterOp)."""
    return mp_ops._apply("sp_reduce_scatter", mp_ops._ReduceScatter, x,
                         group, _SEQ_DIM)


class ScatterOp:
    """Reference-shaped static ``apply`` (sequence_parallel_utils.py:42)."""

    @staticmethod
    def apply(x, group=None):
        return scatter(x, group)


class GatherOp:
    @staticmethod
    def apply(x, group=None):
        return all_gather(x, group)


class AllGatherOp:
    """The sequence slices gathered; the backward reduce-scatters (the
    consumers, column-parallel products, each hold a part of the
    gradient)."""

    @staticmethod
    def apply(x, group=None):
        return mp_ops._apply("sp_all_gather", mp_ops._AllGatherRS, x, group,
                             _SEQ_DIM)


class ReduceScatterOp:
    @staticmethod
    def apply(x, group=None):
        return reduce_scatter(x, group)


def mark_as_sequence_parallel_parameter(param):
    """Mark a parameter applied to sequence slices: its gradient is
    summed over the mp group (once, by the step or the optimizer)."""
    param.sequence_parallel = True
    data = getattr(param, "_data", None)
    if data is not None:
        data.sequence_parallel = True


def is_sequence_parallel_parameter(p) -> bool:
    return getattr(p, "sequence_parallel", False) is True


@torch.no_grad()
def allreduce_sequence_parallel_grads(grads, group):
    """Sum ``grads`` (the gradients of sequence-parallel parameters) over
    ``group`` in place, one flat all-reduce."""
    grads = [g for g in grads if g is not None]
    if not grads or group is None or group.nranks == 1:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    C.all_reduce(flat, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False):
    """Nothing to register (reference :192 sums the sequence-parallel
    gradients in hooks): the port sums them over the mp group once, in
    ``DistributedTrainStep`` or ``HybridParallelOptimizer.step``, as the
    JAX package's hook leaves the sum to GSPMD."""
    return None


def create_fused_allreduce_gradient_hooks(parameter_list=None,
                                          accumulation_steps=1):
    """Nothing to register: the data-parallel reduction is the
    optimizer's or ``DistributedTrainStep``'s (reference :297 fuses the
    hooks' all-reduces; both of the port's reduce one flat buffer)."""
    return None


# -- eager-surface Layers (Paddle's [in, out] layout) ----------------------

class ColumnSequenceParallelLinear(Layer):
    """Sequence-split input [b, s / mp, in] -> all-gather -> the column
    shard's product [b, s, out / mp] (``gather_output``: [b, s, out])
    (reference :429)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self._group = mp_ops._mp_group(mp_group)
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
        x = AllGatherOp.apply(x, self._group)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = mp_ops._c_concat(out, group=self._group)
        return out


class RowSequenceParallelLinear(Layer):
    """Feature-split input [b, s, in / mp] -> the row shard's product ->
    reduce-scatter to a sequence split [b, s / mp, out], the bias (a
    sequence-parallel parameter) added after (reference :564)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear takes a "
                             "feature-split input (input_is_parallel=True)")
        self._group = mp_ops._mp_group(mp_group)
        self._rank, self._n = _rank_degree(self._group)
        _check_divisible("in_features", in_features, self._n)
        self._in_features, self._out_features = in_features, out_features
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        _shard_param(self, "weight", 0, self._group)
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        out = ReduceScatterOp.apply(F.linear(x, self.weight), self._group)
        return out if self.bias is None else out + self.bias


# -- torch.nn.Modules (torch's [out, in] layout), for the port's models ----

class ColumnSequenceParallelLinearModule(ColumnParallelLinearModule):
    """A ``ColumnParallelLinearModule`` whose input is sequence-split: the
    forward all-gathers it (``AllGatherOp``) unless ``sync_input_grad`` is
    False, when the caller gathers once for several products (LLaMA's q,
    k, v and gate, up)."""

    def forward(self, x):
        if self.sync_input_grad:
            x = AllGatherOp.apply(x, self.group)
        out = torch.nn.functional.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = mp_ops._c_concat(out, group=self.group)
        return out


class RowSequenceParallelLinearModule(RowParallelLinearModule):
    """A ``RowParallelLinearModule`` whose output is reduce-scattered to a
    sequence split; its bias, if any, is a sequence-parallel parameter."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        out = torch.nn.functional.linear(x, self.weight)
        if self.mp_degree > 1:
            out = ReduceScatterOp.apply(out, self.group)
        return out if self.bias is None else out + self.bias


__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "scatter", "all_gather", "reduce_scatter",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "ColumnSequenceParallelLinearModule",
           "RowSequenceParallelLinearModule",
           "mark_as_sequence_parallel_parameter",
           "is_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "create_fused_allreduce_gradient_hooks"]
