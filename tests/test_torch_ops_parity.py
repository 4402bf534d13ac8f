"""The eager surface's ops (paddle_tpu_torch.*, .nn.functional) against
the JAX package's, one case per op: the same numpy inputs from a seed
go through both; values, output dtypes (paddle names) and shapes are
compared, and for the floating ops the gradients of every floating input
from ``backward`` on a seeded cotangent. The spec table is this file's
own, in the style of test_op_golden_sweep.py.

Tolerance: float32 within rtol 1e-5 (atol 1e-6; a few special functions
whose libraries round differently state theirs), bfloat16 within 1e-2.
"""
from __future__ import annotations

import zlib

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as place_mod


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


class Spec:
    def __init__(self, name, makers, attrs=None, grad=True, fn=None,
                 rtol=1e-5, atol=1e-6, id=None):
        self.name = name
        self.makers = makers
        self.attrs = attrs or {}
        self.grad = grad
        self.fn = fn            # fn(P, *tensors, **attrs) when not P.<name>
        self.rtol, self.atol = rtol, atol
        self.id = id or name

    def call(self, P, ins):
        if self.fn is not None:
            return self.fn(P, *ins, **self.attrs)
        f = getattr(P, self.name, None) or getattr(P.nn.functional,
                                                   self.name)
        return f(*ins, **self.attrs)


def f32(*shape, lo=-1.0, hi=1.0, seed=0):
    def make(rng):
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return make


def pos(*shape, seed=0):
    return f32(*shape, lo=0.2, hi=2.0)


def ints(*shape, lo=0, hi=4, dtype=np.int64):
    def make(rng):
        return rng.integers(lo, hi, shape).astype(dtype)
    return make


def bools(*shape):
    def make(rng):
        return rng.uniform(size=shape) > 0.4
    return make


def const(value):
    return lambda rng: value


S = (3, 4)
SPECS = []


def add(*specs):
    SPECS.extend(specs)


# -- unary math -------------------------------------------------------------
for name in ["exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
             "tanh", "asinh", "abs", "neg", "sign", "square", "sigmoid",
             "erf", "floor", "ceil", "round", "trunc", "frac", "deg2rad",
             "rad2deg", "logsigmoid", "tanh_shrink", "stanh", "sinc"]:
    add(Spec(name, [f32(*S)]))
for name in ["log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
             "digamma", "lgamma", "i0", "i0e", "i1", "i1e"]:
    add(Spec(name, [pos(*S)], rtol=1e-5 if name not in (
        "digamma", "lgamma", "i0", "i0e", "i1", "i1e") else 1e-4,
        atol=1e-6 if name != "digamma" else 1e-5))
add(Spec("asin", [f32(*S, lo=-0.9, hi=0.9)]),
    Spec("acos", [f32(*S, lo=-0.9, hi=0.9)]),
    Spec("atanh", [f32(*S, lo=-0.9, hi=0.9)]),
    Spec("acosh", [f32(*S, lo=1.2, hi=3.0)]),
    Spec("erfinv", [f32(*S, lo=-0.9, hi=0.9)], rtol=1e-4, atol=1e-5),
    Spec("logit", [f32(*S, lo=0.1, hi=0.9)], attrs=dict(eps=1e-6)),
    Spec("exp", [ints(*S)], grad=False, id="exp_int64"),
    Spec("sqrt", [ints(*S, dtype=np.int32)], grad=False, id="sqrt_int32"),
    Spec("clip", [f32(*S)], attrs=dict(min=-0.5, max=0.3)),
    Spec("scale", [f32(*S)], attrs=dict(scale=2.0, bias=0.5)),
    Spec("scale", [f32(*S)], attrs=dict(scale=2.0, bias=0.5,
                                        bias_after_scale=False),
         id="scale_before"),
    Spec("nan_to_num", [const(np.array([np.nan, np.inf, -np.inf, 1.0],
                                       np.float32))], grad=False))

# -- binary math ------------------------------------------------------------
for name in ["add", "subtract", "multiply", "divide", "maximum", "minimum",
             "fmax", "fmin", "atan2", "hypot", "logaddexp", "remainder",
             "fmod", "copysign"]:
    add(Spec(name, [f32(*S), f32(*S, lo=0.3, hi=1.5)]))
add(Spec("add", [f32(3, 4), f32(4)], id="add_broadcast"),
    Spec("pow", [pos(*S), f32(*S)]),
    Spec("pow", [pos(*S), const(3.0)], id="pow_scalar"),
    Spec("divide", [ints(*S), ints(*S, lo=1, hi=5)], grad=False,
         id="divide_int64"),
    Spec("floor_divide", [ints(*S, lo=-5, hi=9), ints(*S, lo=1, hi=4)],
         grad=False),
    Spec("remainder", [ints(*S, lo=-5, hi=9), ints(*S, lo=1, hi=4)],
         grad=False, id="remainder_int"),
    Spec("multiply", [f32(*S), const(2.5)], id="multiply_scalar"),
    Spec("add", [ints(*S), const(3)], grad=False, id="add_int_scalar"),
    Spec("add", [ints(*S, dtype=np.int32), const(2.5)], grad=False,
         id="add_int32_float_scalar"),
    Spec("multiply", [bools(*S), const(2)], grad=False,
         id="multiply_bool_int_scalar"),
    Spec("lerp", [f32(*S), f32(*S), f32(*S, lo=0, hi=1)]),
    Spec("heaviside", [f32(*S), f32(*S)], grad=False),
    Spec("gcd", [ints(*S, lo=1, hi=30), ints(*S, lo=1, hi=30)], grad=False),
    Spec("multiply_no_nan", [f32(*S), f32(*S)]),
    Spec("add_n", [f32(*S)], fn=lambda P, x: P.add_n([x, x * 2, x])))

# -- reductions -------------------------------------------------------------
for name, attrs in [("sum", {}), ("sum", dict(axis=1, keepdim=True)),
                    ("mean", {}), ("mean", dict(axis=[0, 1])),
                    ("max", dict(axis=1)), ("min", {}), ("amax", {}),
                    ("amin", dict(axis=0)), ("prod", dict(axis=1)),
                    ("prod", {}), ("logsumexp", dict(axis=1)),
                    ("logsumexp", {}), ("nansum", {}), ("nanmean", {}),
                    ("cumsum", dict(axis=1)), ("cumsum", {}),
                    ("cumprod", dict(dim=1)), ("logcumsumexp", dict(axis=0)),
                    ("var", dict(axis=1)), ("std", {}),
                    ("var", dict(unbiased=False), ),
                    ("median", dict(axis=1)), ("median", {}),
                    ("trace", {}), ("diagonal", dict(offset=1))]:
    add(Spec(name, [f32(*S)], attrs=attrs,
             id=name + "_" + "_".join(f"{k}{v}" for k, v in attrs.items())))
add(Spec("sum", [ints(*S, dtype=np.int32)], grad=False, id="sum_int32"),
    Spec("sum", [bools(*S)], grad=False, id="sum_bool"),
    Spec("cumsum", [ints(*S, dtype=np.int32)], attrs=dict(axis=1),
         grad=False, id="cumsum_int32"),
    Spec("mean", [ints(*S)], grad=False, id="mean_int64"),
    Spec("max", [ints(*S, dtype=np.int32)], grad=False, id="max_int32"),
    Spec("cummax", [f32(*S)], attrs=dict(axis=1)),
    Spec("cummin", [f32(*S)], attrs=dict(axis=0)),
    Spec("count_nonzero", [ints(*S)], grad=False),
    Spec("all", [bools(*S)], attrs=dict(axis=1), grad=False),
    Spec("any", [bools(*S)], grad=False),
    Spec("quantile", [f32(*S)], attrs=dict(q=0.3, axis=1)),
    Spec("p_norm", [f32(*S)], attrs=dict(porder=3.0, axis=1)),
    Spec("dist", [f32(*S), f32(*S)]),
    Spec("renorm", [f32(*S)], attrs=dict(p=2.0, axis=0, max_norm=0.5)),
    Spec("diff", [f32(*S)], attrs=dict(axis=1)),
    Spec("trapezoid", [f32(*S)], attrs=dict(dx=0.5)),
    Spec("cumulative_trapezoid", [f32(*S)]))

# -- products ---------------------------------------------------------------
add(Spec("matmul", [f32(3, 4), f32(4, 5)]),
    Spec("matmul", [f32(2, 3, 4), f32(2, 5, 4)],
         attrs=dict(transpose_y=True), id="matmul_ty"),
    Spec("matmul", [f32(4, 3), f32(4, 5)], attrs=dict(transpose_x=True),
         id="matmul_tx"),
    Spec("mm", [f32(3, 4), f32(4, 5)]),
    Spec("bmm", [f32(2, 3, 4), f32(2, 4, 5)]),
    Spec("mv", [f32(3, 4), f32(4)]),
    Spec("dot", [f32(4), f32(4)]),
    Spec("dot", [f32(3, 4), f32(3, 4)], id="dot_2d"),
    Spec("addmm", [f32(3, 5), f32(3, 4), f32(4, 5)],
         attrs=dict(beta=0.5, alpha=2.0)),
    Spec("outer", [f32(3), f32(4)]),
    Spec("inner", [f32(3, 4), f32(2, 4)]),
    Spec("kron", [f32(2, 2), f32(2, 3)]),
    Spec("cross", [f32(4, 3), f32(4, 3)]),
    Spec("tensordot", [f32(3, 4), f32(4, 5)], attrs=dict(axes=1)),
    Spec("matmul", [ints(3, 4, dtype=np.int32), ints(4, 2, dtype=np.int32)],
         grad=False, id="matmul_int32"))

# -- manipulation -----------------------------------------------------------
add(Spec("reshape", [f32(*S)], attrs=dict(shape=[2, 6])),
    Spec("reshape", [f32(*S)], attrs=dict(shape=[-1]), id="reshape_flat"),
    Spec("transpose", [f32(2, 3, 4)], attrs=dict(perm=[2, 0, 1])),
    Spec("t", [f32(*S)]),
    Spec("flatten", [f32(2, 3, 4)], attrs=dict(start_axis=1)),
    Spec("squeeze", [f32(3, 1, 4)], attrs=dict(axis=1)),
    Spec("unsqueeze", [f32(*S)], attrs=dict(axis=[0, 2])),
    Spec("concat", [f32(*S)], fn=lambda P, x: P.concat([x, x * 2], axis=1)),
    Spec("stack", [f32(*S)], fn=lambda P, x: P.stack([x, x + 1], axis=0)),
    Spec("split", [f32(3, 6)], attrs=dict(num_or_sections=3, axis=1)),
    Spec("split", [f32(3, 6)], attrs=dict(num_or_sections=[1, -1, 2],
                                          axis=1), id="split_sections"),
    Spec("chunk", [f32(5, 4)], attrs=dict(chunks=2, axis=0)),
    Spec("unbind", [f32(*S)], attrs=dict(axis=1)),
    Spec("tile", [f32(2, 3)], attrs=dict(repeat_times=[2, 1])),
    Spec("expand", [f32(1, 4)], attrs=dict(shape=[3, 4])),
    Spec("broadcast_to", [f32(4)], attrs=dict(shape=[3, 4])),
    Spec("flip", [f32(*S)], attrs=dict(axis=[1])),
    Spec("roll", [f32(*S)], attrs=dict(shifts=1, axis=1)),
    Spec("gather", [f32(5, 3), ints(4, hi=5)]),
    Spec("gather", [f32(3, 5), ints(2, 2, hi=5)], attrs=dict(axis=1),
         id="gather_2d_index"),
    Spec("gather_nd", [f32(3, 4, 2), ints(5, 2, hi=3)]),
    Spec("take_along_axis", [f32(*S), ints(3, 2, hi=4)],
         attrs=dict(axis=1)),
    Spec("put_along_axis", [f32(*S), ints(3, 1, hi=4), f32(3, 1)],
         attrs=dict(axis=1)),
    Spec("index_select", [f32(*S), ints(3, hi=4)], attrs=dict(axis=1)),
    Spec("index_add", [f32(5, 3), ints(4, hi=5), f32(4, 3)],
         fn=lambda P, x, i, v: P.index_add(x, i, 0, v)),
    Spec("index_sample", [f32(*S), ints(3, 2, hi=4)]),
    Spec("scatter", [f32(5, 3), const(np.array([1, 3, 0])), f32(3, 3)]),
    Spec("scatter", [f32(5, 3), const(np.array([1, 3, 1])), f32(3, 3)],
         attrs=dict(overwrite=False), id="scatter_add"),
    Spec("scatter_nd_add", [f32(4, 3), ints(2, 1, hi=4), f32(2, 3)]),
    Spec("masked_fill", [f32(*S), bools(*S)], attrs=dict(value=0.5)),
    Spec("where", [bools(*S), f32(*S), f32(*S)]),
    Spec("masked_select", [f32(*S), bools(*S)]),
    Spec("pad", [f32(2, 3, 4)], attrs=dict(pad=[1, 2])),
    Spec("pad", [f32(1, 2, 3, 4)], attrs=dict(pad=[1, 0, 2, 1],
                                              mode="reflect"),
         id="pad_reflect"),
    Spec("slice", [f32(4, 5)], attrs=dict(axes=[0, 1], starts=[1, -3],
                                          ends=[3, 10])),
    Spec("strided_slice", [f32(4, 6)], attrs=dict(axes=[1], starts=[0],
                                                  ends=[6], strides=[2])),
    Spec("moveaxis", [f32(2, 3, 4)], attrs=dict(source=0, destination=2)),
    Spec("swapaxes", [f32(2, 3, 4)], attrs=dict(axis1=0, axis2=2)),
    Spec("repeat_interleave", [f32(2, 3)], attrs=dict(repeats=2, axis=1)),
    Spec("tril", [f32(4, 4)], attrs=dict(diagonal=-1)),
    Spec("triu", [f32(4, 4)], attrs=dict(diagonal=1)),
    Spec("diag_embed", [f32(2, 3)]),
    Spec("diag", [f32(4)], attrs=dict(offset=1)),
    Spec("unflatten", [f32(2, 6)], attrs=dict(axis=1, shape=[2, 3])),
    Spec("crop", [f32(4, 5)], attrs=dict(shape=[2, 3], offsets=[1, 1])),
    Spec("unstack", [f32(*S)], attrs=dict(axis=0)),
    Spec("cast", [f32(*S)], attrs=dict(dtype="float64")),
    Spec("cast", [f32(*S)], attrs=dict(dtype="int32"), grad=False,
         id="cast_int32"),
    Spec("cast", [f32(*S)], attrs=dict(dtype="bfloat16"), grad=False,
         id="cast_bf16"),
    Spec("getitem", [f32(4, 5)], fn=lambda P, x: x[1:3, ::2]),
    Spec("getitem", [f32(4, 5)], fn=lambda P, x: x[[0, 2]],
         id="getitem_list"),
    Spec("numel", [f32(*S)], grad=False),
    Spec("shape", [f32(*S)], grad=False),
    Spec("block_diag", [f32(2, 2)], fn=lambda P, x: P.block_diag([x, x])),
    Spec("rot90", [f32(*S)], attrs=dict(k=1, axes=[0, 1])),
    Spec("take", [f32(*S), ints(5, hi=12)]))

# -- logic / search ---------------------------------------------------------
for name in ["equal", "not_equal", "less_than", "less_equal",
             "greater_than", "greater_equal"]:
    add(Spec(name, [ints(*S), ints(*S)], grad=False))
for name in ["logical_and", "logical_or", "logical_xor"]:
    add(Spec(name, [bools(*S), bools(*S)], grad=False))
add(Spec("logical_not", [bools(*S)], grad=False),
    Spec("bitwise_and", [ints(*S, hi=16), ints(*S, hi=16)], grad=False),
    Spec("isclose", [f32(*S), f32(*S)], grad=False),
    Spec("allclose", [f32(*S), f32(*S)], grad=False),
    Spec("equal_all", [ints(*S), ints(*S)], grad=False),
    Spec("isnan", [f32(*S)], grad=False),
    Spec("isfinite", [f32(*S)], grad=False),
    Spec("isin", [ints(*S, hi=8), ints(3, hi=8)], grad=False),
    Spec("argmax", [f32(*S)], attrs=dict(axis=1), grad=False),
    Spec("argmax", [f32(*S)], grad=False, id="argmax_flat"),
    Spec("argmin", [f32(*S)], attrs=dict(axis=0, keepdim=True), grad=False),
    Spec("argsort", [f32(*S)], attrs=dict(axis=1, descending=True),
         grad=False),
    Spec("sort", [f32(*S)], attrs=dict(axis=1)),
    Spec("topk", [f32(*S)], attrs=dict(k=2)),
    Spec("topk", [f32(*S)], attrs=dict(k=2, axis=0, largest=False),
         id="topk_smallest"),
    Spec("kthvalue", [f32(*S)], attrs=dict(k=2, axis=1)),
    Spec("mode", [ints(3, 6, hi=3)], grad=False),
    Spec("searchsorted", [const(np.array([0.1, 0.3, 0.5, 0.9], np.float32)),
                          f32(5, lo=0, hi=1)], grad=False),
    Spec("nonzero", [bools(*S)], grad=False),
    Spec("unique", [ints(8, hi=4)], grad=False))

# -- creation (deterministic) -----------------------------------------------
add(Spec("zeros", [], fn=lambda P: P.zeros([2, 3]), grad=False),
    Spec("ones", [], fn=lambda P: P.ones([2, 3], dtype="int32"), grad=False),
    Spec("full", [], fn=lambda P: P.full([2, 2], 3), grad=False),
    Spec("full", [], fn=lambda P: P.full([2, 2], 1.5), grad=False,
         id="full_float"),
    Spec("arange", [], fn=lambda P: P.arange(5), grad=False),
    Spec("arange", [], fn=lambda P: P.arange(0.0, 1.0, 0.25), grad=False,
         id="arange_float"),
    Spec("linspace", [], fn=lambda P: P.linspace(0, 1, 5), grad=False),
    Spec("eye", [], fn=lambda P: P.eye(3, 4), grad=False),
    Spec("zeros_like", [f32(*S)], grad=False),
    Spec("full_like", [ints(*S)], attrs=dict(fill_value=7), grad=False),
    Spec("tril_indices", [], fn=lambda P: P.tril_indices(3, 3), grad=False),
    Spec("meshgrid", [f32(3), f32(2)],
         fn=lambda P, x, y: P.meshgrid(x, y)),
    Spec("to_tensor", [], fn=lambda P: P.to_tensor([1.5, 2.0]),
         grad=False),
    Spec("to_tensor", [], fn=lambda P: P.to_tensor(3), grad=False,
         id="to_tensor_int"),
    Spec("to_tensor", [], fn=lambda P: P.to_tensor(np.ones(2)), grad=False,
         id="to_tensor_f64_array"),
    Spec("clone", [f32(*S)]),
    Spec("assign", [f32(*S)], grad=False))

# -- nn.functional ----------------------------------------------------------
for name in ["relu", "relu6", "silu", "gelu", "mish", "softsign",
             "log_sigmoid", "hardswish", "hardsigmoid", "tanhshrink",
             "selu", "softplus", "hardtanh", "hardshrink", "softshrink",
             "leaky_relu", "elu", "celu"]:
    add(Spec(name, [f32(*S, lo=-2, hi=2)], id="F." + name))
add(Spec("gelu", [f32(*S, lo=-2, hi=2)], attrs=dict(approximate=True),
         id="F.gelu_tanh"),
    Spec("softmax", [f32(*S)], fn=lambda P, x: P.nn.functional.softmax(
        x, axis=0), id="F.softmax"),
    Spec("log_softmax", [f32(*S)],
         fn=lambda P, x: P.nn.functional.log_softmax(x), id="F.log_softmax"),
    Spec("glu", [f32(3, 4)], fn=lambda P, x: P.nn.functional.glu(x),
         id="F.glu"),
    Spec("swiglu", [f32(3, 4), f32(3, 4)],
         fn=lambda P, x, y: P.nn.functional.swiglu(x, y), id="F.swiglu"),
    Spec("prelu", [f32(2, 3, 4), f32(3)],
         fn=lambda P, x, w: P.nn.functional.prelu(x, w), id="F.prelu"),
    Spec("maxout", [f32(2, 4, 3)],
         fn=lambda P, x: P.nn.functional.maxout(x, 2), id="F.maxout"),
    Spec("linear", [f32(3, 4), f32(4, 5), f32(5)],
         fn=lambda P, x, w, b: P.nn.functional.linear(x, w, b),
         id="F.linear"),
    Spec("layer_norm", [f32(3, 8), f32(8), f32(8)],
         fn=lambda P, x, w, b: P.nn.functional.layer_norm(x, 8, w, b),
         id="F.layer_norm"),
    Spec("rms_norm", [f32(3, 8), f32(8)],
         fn=lambda P, x, w: P.nn.functional.rms_norm(x, w),
         id="F.rms_norm"),
    Spec("normalize", [f32(3, 8)],
         fn=lambda P, x: P.nn.functional.normalize(x, axis=1),
         id="F.normalize"),
    Spec("group_norm", [f32(2, 4, 3), f32(4), f32(4)],
         fn=lambda P, x, w, b: P.nn.functional.group_norm(
             x, 2, weight=w, bias=b), id="F.group_norm", rtol=1e-4,
         atol=1e-5),
    Spec("embedding", [ints(2, 3, hi=6), f32(6, 4)],
         fn=lambda P, i, w: P.nn.functional.embedding(i, w, padding_idx=2),
         id="F.embedding"),
    Spec("one_hot", [ints(5, hi=4)],
         fn=lambda P, x: P.nn.functional.one_hot(x, 4), grad=False,
         id="F.one_hot"),
    Spec("cosine_similarity", [f32(3, 4), f32(3, 4)],
         fn=lambda P, x, y: P.nn.functional.cosine_similarity(x, y),
         id="F.cosine_similarity"),
    Spec("pairwise_distance", [f32(3, 4), f32(3, 4)],
         fn=lambda P, x, y: P.nn.functional.pairwise_distance(x, y),
         id="F.pairwise_distance"),
    Spec("label_smooth", [f32(3, 4, lo=0, hi=1)],
         fn=lambda P, x: P.nn.functional.label_smooth(x),
         id="F.label_smooth"),
    Spec("dropout", [f32(*S)],
         fn=lambda P, x: P.nn.functional.dropout(
             x, 0.3, training=False, mode="downscale_in_infer"),
         id="F.dropout_infer"),
    Spec("cross_entropy", [f32(6, 5), ints(6, hi=5)],
         fn=lambda P, x, y: P.nn.functional.cross_entropy(x, y),
         id="F.cross_entropy"),
    Spec("cross_entropy", [f32(6, 5), ints(6, 1, hi=5), pos(5)],
         fn=lambda P, x, y, w: P.nn.functional.cross_entropy(
             x, y, weight=w, reduction="mean"), id="F.cross_entropy_weight"),
    Spec("cross_entropy", [f32(6, 5), f32(6, 5, lo=0, hi=1)],
         fn=lambda P, x, y: P.nn.functional.cross_entropy(
             x, y, soft_label=True), id="F.cross_entropy_soft"),
    Spec("cross_entropy", [f32(6, 5), ints(6, hi=5)],
         fn=lambda P, x, y: P.nn.functional.cross_entropy(
             x, y, label_smoothing=0.1, reduction="none"),
         id="F.cross_entropy_smooth"),
    Spec("cross_entropy", [f32(6, 5, lo=0.05, hi=1), ints(6, hi=5)],
         fn=lambda P, x, y: P.nn.functional.cross_entropy(
             x, y, use_softmax=False), id="F.cross_entropy_probs"),
    Spec("nll_loss", [f32(6, 5), ints(6, hi=5)],
         fn=lambda P, x, y: P.nn.functional.nll_loss(x, y),
         id="F.nll_loss"),
    Spec("mse_loss", [f32(*S), f32(*S)],
         fn=lambda P, x, y: P.nn.functional.mse_loss(x, y), id="F.mse_loss"),
    Spec("l1_loss", [f32(*S), f32(*S)],
         fn=lambda P, x, y: P.nn.functional.l1_loss(x, y, "sum"),
         id="F.l1_loss"),
    Spec("smooth_l1_loss", [f32(*S), f32(*S)],
         fn=lambda P, x, y: P.nn.functional.smooth_l1_loss(x, y),
         id="F.smooth_l1_loss"),
    Spec("binary_cross_entropy", [f32(*S, lo=0.1, hi=0.9),
                                  f32(*S, lo=0, hi=1)],
         fn=lambda P, x, y: P.nn.functional.binary_cross_entropy(x, y),
         id="F.binary_cross_entropy"),
    Spec("binary_cross_entropy_with_logits", [f32(*S), f32(*S, lo=0, hi=1),
                                              pos(4)],
         fn=lambda P, x, y, pw:
         P.nn.functional.binary_cross_entropy_with_logits(
             x, y, pos_weight=pw), id="F.bce_with_logits"),
    Spec("kl_div", [f32(*S), f32(*S, lo=0.1, hi=1)],
         fn=lambda P, x, y: P.nn.functional.kl_div(x, y, "batchmean"),
         id="F.kl_div"),
    Spec("sigmoid_focal_loss", [f32(*S), f32(*S, lo=0, hi=1)],
         fn=lambda P, x, y: P.nn.functional.sigmoid_focal_loss(x, y),
         id="F.sigmoid_focal_loss"),
    Spec("margin_ranking_loss", [f32(4), f32(4), const(np.array(
        [1, -1, 1, -1], np.float32))],
         fn=lambda P, x, y, z: P.nn.functional.margin_ranking_loss(
             x, y, z, 0.1), id="F.margin_ranking_loss"),
    Spec("ctc_loss", [f32(6, 2, 5), ints(2, 3, lo=1, hi=5),
                      const(np.array([6, 5])), const(np.array([3, 2]))],
         fn=lambda P, lp, lab, il, ll: P.nn.functional.ctc_loss(
             lp, lab, il, ll), id="F.ctc_loss", rtol=1e-4, atol=1e-5),
    Spec("rnnt_loss", [f32(2, 4, 3, 5), ints(2, 2, lo=1, hi=5),
                       const(np.array([4, 3])), const(np.array([2, 1]))],
         fn=lambda P, x, lab, il, ll: P.nn.functional.rnnt_loss(
             x, lab, il, ll), id="F.rnnt_loss", rtol=1e-4, atol=1e-5),
    Spec("scaled_dot_product_attention",
         [f32(2, 5, 2, 8), f32(2, 5, 2, 8), f32(2, 5, 2, 8),
          const(np.array([[[[True] * 5]], [[[True] * 3 + [False] * 2]]]))],
         fn=lambda P, q, k, v, m:
         P.nn.functional.scaled_dot_product_attention(q, k, v, m),
         id="F.sdpa_key_mask", rtol=1e-4, atol=1e-5),
    Spec("scaled_dot_product_attention",
         [f32(2, 5, 2, 8), f32(2, 5, 2, 8), f32(2, 5, 2, 8)],
         fn=lambda P, q, k, v: P.nn.functional.scaled_dot_product_attention(
             q, k, v, is_causal=True), id="F.sdpa_causal", rtol=1e-4,
         atol=1e-5),
    Spec("scaled_dot_product_attention",
         [f32(2, 5, 2, 8), f32(2, 5, 2, 8), f32(2, 5, 2, 8),
          f32(2, 2, 5, 5)],
         fn=lambda P, q, k, v, m:
         P.nn.functional.scaled_dot_product_attention(q, k, v, m),
         id="F.sdpa_dense_mask", rtol=1e-4, atol=1e-5),
    Spec("flash_attention", [f32(2, 5, 2, 8), f32(2, 5, 2, 8),
                             f32(2, 5, 2, 8)],
         fn=lambda P, q, k, v: P.nn.functional.flash_attention(
             q, k, v, causal=True, return_softmax=True),
         id="F.flash_attention_softmax", rtol=1e-4, atol=1e-5),
    Spec("flash_attn_unpadded", [f32(7, 2, 8), f32(7, 2, 8), f32(7, 2, 8),
                                 const(np.array([0, 3, 7], np.int32)),
                                 const(np.array([0, 3, 7], np.int32))],
         fn=lambda P, q, k, v, cq, ck: P.nn.functional.flash_attn_unpadded(
             q, k, v, cq, ck, 4, 4, 0.35, causal=True)[0],
         id="F.flash_attn_unpadded", rtol=1e-4, atol=1e-5),
    Spec("sequence_mask", [const(np.array([1, 3, 2]))],
         fn=lambda P, n: P.nn.functional.sequence_mask(n, 4), grad=False,
         id="F.sequence_mask"))

# -- the rest of the ported ops (one case each) -----------------------------
F_ = "F."


def _t(P, v):
    """A Python / torch result as the package's Tensor (for ops that return
    lists, bools or, in the port's document mask, a raw tensor)."""
    if hasattr(v, "place"):
        return v
    if hasattr(v, "detach"):
        return P.to_tensor(v.detach().cpu().numpy())
    return P.to_tensor(np.asarray(v))


SORTED = const(np.array([-0.5, 0.0, 0.25, 0.8], np.float32))
NANS = const(np.array([np.nan, np.inf, -np.inf, 1.0, -0.0], np.float32))
add(Spec("diagflat", [f32(3)]),
    Spec("empty", [], fn=lambda P: P.empty([2, 3]), grad=False),
    Spec("empty_like", [ints(*S)], grad=False),
    Spec("ones_like", [f32(*S)], grad=False),
    Spec("logspace", [], fn=lambda P: P.logspace(0, 2, 5), grad=False,
         rtol=1e-5),
    Spec("triu_indices", [], fn=lambda P: P.triu_indices(3, 4, 1),
         grad=False),
    Spec("full_with_tensor", [const(np.array(2.5, np.float32)),
                              const(np.array([2, 3]))], grad=False),
    Spec("full_int_array", [], fn=lambda P: P.full_int_array([3, 1, 2]),
         grad=False),
    Spec("full_batch_size_like", [f32(5, 2)], grad=False,
         fn=lambda P, x: P.full_batch_size_like(x, [1, 3], "float32", 1.5)),
    Spec("complex", [f32(*S), f32(*S)], grad=False),
    Spec("polar", [pos(*S), f32(*S)], grad=False),
    Spec("clone_detached", [f32(*S)], grad=False),
    Spec("add_position_encoding", [f32(2, 3, 4)]),
    Spec("angle", [f32(*S)], grad=False),
    Spec("bincount", [ints(6, hi=4)], grad=False),
    Spec("broadcast_shape", [], grad=False,
         fn=lambda P: _t(P, P.broadcast_shape([3, 1], [1, 4]))),
    Spec("clip_by_norm", [f32(*S)], attrs=dict(max_norm=0.5)),
    Spec("combinations", [f32(4)]),
    Spec("conj", [f32(*S)]),
    Spec("divide_int_to_float", [ints(*S), ints(*S, lo=1, hi=5)],
         grad=False),
    Spec("edit_distance", [ints(2, 4, hi=3), ints(2, 3, hi=3)],
         grad=False),
    Spec("exponent", [pos(*S)], grad=False),
    Spec("frexp", [f32(*S)], grad=False),
    Spec("frobenius_norm", [f32(*S)]),
    Spec("gammainc", [pos(*S), pos(*S)], grad=False, rtol=1e-4),
    Spec("gammaincc", [pos(*S), pos(*S)], grad=False, rtol=1e-4),
    Spec("histogram", [f32(20)], attrs=dict(bins=5, min=-1, max=1),
         grad=False),
    Spec("histogramdd", [f32(10, 2)], attrs=dict(bins=3), grad=False),
    Spec("imag", [f32(*S)], grad=False),
    Spec("real", [f32(*S)]),
    Spec("increment", [f32(*S)], grad=False,
         fn=lambda P, x: P.increment(x, 2.0)),
    Spec("isinf", [NANS], grad=False),
    Spec("isneginf", [NANS], grad=False),
    Spec("isposinf", [NANS], grad=False),
    Spec("isreal", [f32(*S)], grad=False),
    Spec("signbit", [NANS], grad=False),
    Spec("l1_norm", [f32(*S)]),
    Spec("squared_l2_norm", [f32(*S)]),
    Spec("mean_all", [f32(*S)]),
    Spec("log_normalize", [f32(*S)]),
    Spec("lcm", [ints(*S, lo=1, hi=12), ints(*S, lo=1, hi=12)], grad=False),
    Spec("ldexp", [f32(*S), ints(*S, hi=3, dtype=np.int32)], grad=False),
    Spec("multigammaln", [f32(*S, lo=1.5, hi=3)], attrs=dict(p=2),
         rtol=1e-4, atol=1e-5),
    Spec("multiplex", [f32(3, 2), f32(3, 2), const(np.array([[1], [0],
                                                              [1]]))],
         fn=lambda P, a, b, i: P.multiplex([a, b], i)),
    Spec("nextafter", [f32(*S), f32(*S)], grad=False),
    Spec("polygamma", [pos(*S)], attrs=dict(n=1), rtol=1e-4, atol=1e-5),
    Spec("positive", [f32(*S)]),
    Spec("pow_", [pos(*S), f32(*S)]),
    Spec("reduce_as", [f32(2, 3, 4), f32(3, 1)]),
    Spec("vander", [f32(3)], attrs=dict(n=4)),
    Spec("as_complex", [f32(3, 2)], grad=False),
    Spec("as_real", [f32(3, 2)], grad=False,
         fn=lambda P, x: P.as_real(P.as_complex(x))),
    Spec("as_strided", [f32(12)], attrs=dict(shape=[3, 2], stride=[2, 1]),
         grad=False),
    Spec("assign_out_", [f32(*S), f32(*S)], grad=False),
    Spec("assign_value_", [f32(2, 2)], grad=False,
         fn=lambda P, o: P.assign_value_(o, [2, 2], "float32",
                                         [1.0, 2.0, 3.0, 4.0])),
    Spec("atleast_1d", [const(np.array(1.5, np.float32))]),
    Spec("atleast_2d", [f32(3)]),
    Spec("atleast_3d", [f32(3)]),
    Spec("broadcast_tensors", [f32(3, 1), f32(4)],
         fn=lambda P, x, y: P.broadcast_tensors([x, y])),
    Spec("cartesian_prod", [f32(2), f32(3)],
         fn=lambda P, x, y: P.cartesian_prod([x, y])),
    Spec("column_stack", [f32(3), f32(3)],
         fn=lambda P, x, y: P.column_stack([x, y])),
    Spec("hstack", [f32(*S), f32(*S)], fn=lambda P, x, y: P.hstack([x, y])),
    Spec("vstack", [f32(*S), f32(*S)], fn=lambda P, x, y: P.vstack([x, y])),
    Spec("row_stack", [f32(*S), f32(*S)],
         fn=lambda P, x, y: P.row_stack([x, y])),
    Spec("dstack", [f32(*S), f32(*S)], fn=lambda P, x, y: P.dstack([x, y])),
    Spec("diagonal_scatter", [f32(3, 3), f32(3)]),
    Spec("dsplit", [f32(2, 2, 6)], attrs=dict(num_or_indices=3)),
    Spec("hsplit", [f32(2, 6)], attrs=dict(num_or_indices=2)),
    Spec("vsplit", [f32(4, 3)], attrs=dict(num_or_indices=2)),
    Spec("tensor_split", [f32(7, 2)], attrs=dict(num_or_indices=3)),
    Spec("expand_as", [f32(1, 4), f32(3, 4)]),
    Spec("fill", [f32(*S)], grad=False, fn=lambda P, x: P.fill(x, 2.0)),
    Spec("fill_diagonal", [f32(3, 4)], attrs=dict(value=5.0)),
    Spec("fill_diagonal_", [f32(4, 3)], grad=False,
         fn=lambda P, x: P.fill_diagonal_(x, 5.0, wrap=True)),
    Spec("fill_diagonal_tensor", [f32(3, 3), f32(3)]),
    Spec("fliplr", [f32(*S)]),
    Spec("flipud", [f32(*S)]),
    Spec("frame", [f32(2, 10)], attrs=dict(frame_length=4, hop_length=2)),
    Spec("overlap_add", [f32(2, 4, 3)], attrs=dict(hop_length=2)),
    Spec("index_fill", [f32(*S), ints(2, hi=3)],
         fn=lambda P, x, i: P.index_fill(x, i, 0, 1.5)),
    Spec("index_put", [f32(*S), f32(2)],
         fn=lambda P, x, v: P.index_put(
             x, (P.to_tensor(np.array([0, 2])),
                 P.to_tensor(np.array([1, 3]))), v)),
    Spec("index_select_strided", [f32(*S), ints(2, hi=3)]),
    Spec("is_complex", [f32(*S)], grad=False,
         fn=lambda P, x: _t(P, [P.is_complex(x), P.is_floating_point(x),
                                P.is_integer(x), P.is_tensor(x)])),
    Spec("is_empty", [f32(*S)], grad=False),
    Spec("rank", [f32(2, 3, 4)], grad=False),
    Spec("masked_scatter", [f32(*S), bools(*S), f32(12)]),
    Spec("repeat_interleave_with_tensor_index",
         [f32(3, 2), const(np.array([1, 2, 1]))], attrs=dict(axis=0)),
    Spec("reverse", [f32(*S)], attrs=dict(axis=[0])),
    Spec("scatter_nd", [const(np.array([[1], [3]])), f32(2, 3)],
         attrs=dict(shape=[4, 3])),
    Spec("select_scatter", [f32(3, 4), f32(4)],
         attrs=dict(axis=0, index=1)),
    Spec("slice_scatter", [f32(4, 5), f32(2, 5)],
         attrs=dict(axes=[0], starts=[1], ends=[3])),
    Spec("shard_index", [ints(6, hi=20)], grad=False,
         attrs=dict(index_num=20, nshards=2, shard_id=1)),
    Spec("split_with_num", [f32(3, 6)], attrs=dict(num=2, axis=1)),
    Spec("tolist", [f32(*S)], grad=False,
         fn=lambda P, x: _t(P, P.tolist(x))),
    Spec("trans_layout", [f32(2, 3, 4)], attrs=dict(perm=[1, 0, 2])),
    Spec("unfold", [f32(3, 8)], attrs=dict(axis=1, size=3, step=2)),
    Spec("unique_consecutive", [const(np.array([1, 1, 2, 2, 3, 1]))],
         attrs=dict(return_inverse=True, return_counts=True), grad=False),
    Spec("view", [f32(*S)], attrs=dict(shape_or_dtype=[2, 6])),
    Spec("view_as", [f32(*S), f32(6, 2)]),
    Spec("view_shape", [f32(*S)], attrs=dict(shape=[6, 2])),
    Spec("view_dtype", [f32(*S)], attrs=dict(dtype="int32"), grad=False),
    Spec("bitwise_not", [ints(*S, hi=16)], grad=False),
    Spec("bitwise_invert", [ints(*S, hi=16)], grad=False),
    Spec("bitwise_or", [ints(*S, hi=16), ints(*S, hi=16)], grad=False),
    Spec("bitwise_xor", [ints(*S, hi=16), ints(*S, hi=16)], grad=False),
    Spec("bitwise_left_shift", [ints(*S, hi=16), ints(*S, hi=3)],
         grad=False),
    Spec("bitwise_right_shift", [ints(*S, hi=16), ints(*S, hi=3)],
         grad=False),
    Spec("is_same_shape", [f32(*S), f32(*S)], grad=False,
         fn=lambda P, x, y: _t(P, P.is_same_shape(x, y))),
    Spec("less", [ints(*S), ints(*S)], grad=False),
    Spec("bucketize", [f32(5, lo=-1, hi=1), SORTED], grad=False),
    Spec("gather_tree", [ints(3, 2, 2, hi=9), ints(3, 2, 2, hi=2)],
         grad=False),
    Spec("viterbi_decode", [f32(2, 4, 3), f32(3, 3),
                            const(np.array([4, 3]))], grad=False),
    Spec("accuracy", [f32(4, 5), ints(4, 1, hi=5)], grad=False),
    Spec("auc", [f32(6, 2, lo=0, hi=1), ints(6, 1, hi=2)], grad=False),
    Spec("corrcoef", [f32(3, 5)]),
    Spec("cov", [f32(3, 5)]),
    Spec("histogram_bin_edges", [f32(10)], attrs=dict(bins=4), grad=False),
    Spec("nanmedian", [f32(*S)], attrs=dict(axis=1)),
    Spec("nanquantile", [f32(*S)], attrs=dict(q=0.5, axis=1)))


def _F(name, makers, call, **kw):
    add(Spec(name, makers, id=F_ + name, **kw,
             fn=lambda P, *a: call(P.nn.functional, P, *a)))


_F("adaptive_log_softmax_with_loss",
   [f32(4, 8), ints(4, hi=6), f32(8, 3), f32(8, 2), f32(2, 4)],
   lambda F, P, x, lab, hw, w1, w2: F.adaptive_log_softmax_with_loss(
       x, lab, hw, [(w1, w2)], [2, 6]))
_F("batch_norm", [f32(4, 3), f32(3), pos(3), f32(3), f32(3)],
   lambda F, P, x, m, v, w, b: F.batch_norm(x, m, v, w, b))
_F("bilinear", [f32(2, 3), f32(2, 4), f32(5, 3, 4), f32(5)],
   lambda F, P, a, b, w, bb: F.bilinear(a, b, w, bb))
_F("cosine_embedding_loss", [f32(3, 4), f32(3, 4),
                             const(np.array([1, -1, 1]))],
   lambda F, P, a, b, y: F.cosine_embedding_loss(a, b, y))
_F("dice_loss", [f32(4, 3, lo=0, hi=1), ints(4, 1, hi=3)],
   lambda F, P, p, y: F.dice_loss(p, y))
_F("document_startend_row_indices", [], grad=False,
   call=lambda F, P: _t(P, F.document_startend_row_indices([2, 3])))
for _n in ("elu_", "hardtanh_", "leaky_relu_", "relu_", "softmax_",
           "tanh_", "thresholded_relu_"):
    _F(_n, [f32(*S, lo=-2, hi=2)],
       lambda F, P, x, _n=_n: getattr(F, _n)(x * 1.0))
_F("thresholded_relu", [f32(*S, lo=-2, hi=2)],
   lambda F, P, x: F.thresholded_relu(x, 0.5))
_F("flash_attn", [f32(2, 5, 2, 8)] * 3,
   lambda F, P, q, k, v: F.flash_attn(q, k, v, causal=True)[0],
   rtol=1e-4, atol=1e-5)
_F("flash_attn_qkvpacked", [f32(2, 5, 3, 2, 8)],
   lambda F, P, qkv: F.flash_attn_qkvpacked(qkv)[0], rtol=1e-4, atol=1e-5)
_F("flash_attn_varlen_qkvpacked",
   [f32(7, 3, 2, 8), const(np.array([0, 3, 7], np.int32)),
    const(np.array([0, 3, 7], np.int32))],
   lambda F, P, qkv, cq, ck: F.flash_attn_varlen_qkvpacked(
       qkv, cq, ck, 4, 4)[0], rtol=1e-4, atol=1e-5)
_F("flashmask_attention",
   [f32(1, 6, 2, 8)] * 3 + [const(np.array([3, 3, 3, 6, 6, 6], np.int32)
                                  .reshape(1, 1, 6, 1))],
   lambda F, P, q, k, v, se: F.flashmask_attention(q, k, v, se,
                                                   causal=True),
   rtol=1e-4, atol=1e-5)
_F("memory_efficient_attention", [f32(2, 5, 2, 8)] * 3,
   lambda F, P, q, k, v: F.memory_efficient_attention(q, k, v),
   rtol=1e-4, atol=1e-5)
_F("fused_softmax_mask", [f32(2, 3, 4), f32(2, 3, 4)],
   lambda F, P, x, m: F.fused_softmax_mask(x, m))
_F("fused_softmax_mask_upper_triangle", [f32(2, 4, 4)],
   lambda F, P, x: F.fused_softmax_mask_upper_triangle(x))
_F("gaussian_nll_loss", [f32(*S), f32(*S), pos(*S)],
   lambda F, P, x, y, v: F.gaussian_nll_loss(x, y, v))
_F("hinge_embedding_loss", [f32(*S), const(np.sign(np.arange(12) - 5.5)
                                           .reshape(3, 4).astype(
                                               np.float32))],
   lambda F, P, x, y: F.hinge_embedding_loss(x, y))
_F("hinge_loss", [f32(*S), f32(*S, lo=0, hi=1)],
   lambda F, P, x, y: F.hinge_loss(x, y))
_F("hsigmoid_loss", [f32(4, 5), ints(4, hi=6), f32(5, 5), f32(5)],
   lambda F, P, x, y, w, b: F.hsigmoid_loss(x, y, 6, w, b))
_F("huber_loss", [f32(*S), f32(*S)], lambda F, P, x, y: F.huber_loss(x, y))
_F("identity_loss", [f32(*S)], lambda F, P, x: F.identity_loss(x, "mean"))
_F("instance_norm", [f32(2, 3, 4), f32(3), f32(3)],
   lambda F, P, x, w, b: F.instance_norm(x, weight=w, bias=b),
   rtol=1e-4, atol=1e-5)
_F("local_response_norm", [f32(2, 5, 3)],
   lambda F, P, x: F.local_response_norm(x, 3))
_F("log_loss", [f32(*S, lo=0.1, hi=0.9), f32(*S, lo=0, hi=1)],
   lambda F, P, x, y: F.log_loss(x, y))
_F("margin_cross_entropy", [f32(4, 5, lo=-0.9, hi=0.9), ints(4, hi=5)],
   lambda F, P, x, y: F.margin_cross_entropy(x, y), rtol=1e-4, atol=1e-5)
_F("multi_label_soft_margin_loss", [f32(*S), f32(*S, lo=0, hi=1)],
   lambda F, P, x, y: F.multi_label_soft_margin_loss(x, y))
_F("multi_margin_loss", [f32(4, 5), ints(4, hi=5)],
   lambda F, P, x, y: F.multi_margin_loss(x, y))
_F("npair_loss", [f32(4, 3), f32(4, 3), ints(4, hi=2)],
   lambda F, P, a, p, y: F.npair_loss(a, p, y))
_F("pad3d", [f32(1, 1, 2, 3, 4)],
   lambda F, P, x: F.pad3d(x, [1, 1, 1, 0, 0, 1]))
_F("poisson_nll_loss", [f32(*S), pos(*S)],
   lambda F, P, x, y: F.poisson_nll_loss(x, y))
_F("soft_margin_loss", [f32(*S), const(np.sign(np.arange(12) - 5.5)
                                       .reshape(3, 4).astype(np.float32))],
   lambda F, P, x, y: F.soft_margin_loss(x, y))
_F("sparse_attention",
   [f32(1, 1, 4, 8)] * 3 + [const(np.array([[[0, 2, 4, 6, 8]]], np.int32)),
                            const(np.array([[[0, 1, 0, 2, 1, 3, 2, 3]]],
                                           np.int32))],
   lambda F, P, q, k, v, off, cols: F.sparse_attention(q, k, v, off, cols),
   rtol=1e-4, atol=1e-5)
_F("square_error_cost", [f32(*S), f32(*S)],
   lambda F, P, x, y: F.square_error_cost(x, y))
_F("temporal_shift", [f32(4, 4, 2, 2)],
   lambda F, P, x: F.temporal_shift(x, 2))
_F("triplet_margin_loss", [f32(3, 4)] * 3,
   lambda F, P, a, p, n: F.triplet_margin_loss(a, p, n))
_F("triplet_margin_with_distance_loss", [f32(3, 4)] * 3,
   lambda F, P, a, p, n: F.triplet_margin_with_distance_loss(a, p, n))
_F("zeropad2d", [f32(1, 1, 2, 3)],
   lambda F, P, x: F.zeropad2d(x, [1, 0, 1, 0]))
for _n, _call in {
        "flatten_": lambda P, x: P.flatten_(x),
        "reshape_": lambda P, x: P.reshape_(x, [4, 3]),
        "squeeze_": lambda P, x: P.squeeze_(P.unsqueeze(x, 0), 0),
        "unsqueeze_": lambda P, x: P.unsqueeze_(x, 1),
        "index_add_": lambda P, x: P.index_add_(
            x, P.to_tensor(np.array([0, 2])), 0, P.ones([2, 4])),
        "index_fill_": lambda P, x: P.index_fill_(
            x, P.to_tensor(np.array([1])), 1, -1.0),
        "index_put_": lambda P, x: P.index_put_(
            x, (P.to_tensor(np.array([0, 2])),), P.ones([4])),
        "masked_fill_": lambda P, x: P.masked_fill_(x, x > 0, 0.5),
        "scatter_": lambda P, x: P.scatter_(
            x, P.to_tensor(np.array([2, 0])), P.zeros([2, 4])),
        "where_": lambda P, x: P.where_(x > 0, x, x * 2),
        "is_floating_point": lambda P, x: _t(P, [
            P.is_floating_point(x), P.is_integer(x), P.is_tensor(x)]),
}.items():
    add(Spec(_n, [f32(*S)], grad=False,
             fn=lambda P, x, _c=_call: _c(P, x * 1.0)))
_F("alpha_dropout", [f32(*S)],
   lambda F, P, x: F.alpha_dropout(x, 0.3, training=False))

# -- bfloat16 ---------------------------------------------------------------
for name, makers, fn in [
        ("add", [f32(*S), f32(*S)], None),
        ("matmul", [f32(3, 8), f32(8, 4)], None),
        ("exp", [f32(*S)], None),
        ("gelu", [f32(*S)], lambda P, x: P.nn.functional.gelu(x)),
        ("layer_norm", [f32(3, 8)],
         lambda P, x: P.nn.functional.layer_norm(x, 8)),
        ("softmax", [f32(*S)], lambda P, x: P.nn.functional.softmax(x)),
        ("sum", [f32(*S)], None)]:
    add(Spec(name, makers, fn=fn, rtol=1e-2, atol=1e-2, id=name + "_bf16"))

BF16 = {s.id for s in SPECS if s.id.endswith("_bf16")}


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(spec, P, arrays):
    ins = []
    for arr in arrays:
        if isinstance(arr, np.ndarray):
            t = P.to_tensor(arr)
            if spec.id in BF16 and arr.dtype == np.float32:
                t = t.astype("bfloat16")
            if spec.grad and t.dtype.name in ("float32", "bfloat16"):
                t.stop_gradient = False
            ins.append(t)
        else:
            ins.append(arr)
    out = spec.call(P, ins)
    outs = [o for o in _flat(out) if hasattr(o, "numpy")]
    grads = []
    if spec.grad:
        rng = np.random.default_rng(7)
        loss = None
        for o in outs:
            if o.dtype.name not in ("float32", "bfloat16", "float64") \
                    or o.stop_gradient:
                continue
            cot = P.to_tensor(rng.standard_normal(o.shape).astype(
                np.float32)).astype(o.dtype.name)
            term = (o * cot).sum()
            loss = term if loss is None else loss + term
        if loss is not None:
            loss.backward()
            grads = [t.grad for t in ins if hasattr(t, "grad")
                     and not t.stop_gradient]
    return outs, grads


def _np(t):
    a = np.asarray(t.numpy())
    return a.astype(np.float64) if a.dtype.kind in "fcV" or \
        a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.id)
def test_op_matches_jax(spec):
    rng = np.random.default_rng(zlib.crc32(spec.id.encode()))
    arrays = [m(rng) for m in spec.makers]
    want, wgrads = _run(spec, jp, arrays)
    got, tgrads = _run(spec, tp, arrays)
    assert len(got) == len(want)
    tol = dict(rtol=spec.rtol, atol=spec.atol)
    for g, w in zip(got, want):
        assert g.dtype.name == w.dtype.name, (spec.id, g.dtype, w.dtype)
        assert g.shape == w.shape, (spec.id, g.shape, w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **tol)
    assert len(tgrads) == len(wgrads)
    for g, w in zip(tgrads, wgrads):
        if g is None and w is not None:
            # an input that does not reach the output: the JAX tape gives
            # it zeros, torch autograd nothing (ROADMAP section 3)
            assert not _np(w).any(), spec.id
            continue
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(_np(g), _np(w), **tol)


# -- random ops: held to the JAX ones' shapes, dtypes and ranges ------------
# (threefry streams cannot be reproduced; the distributions are held in
# test_torch_nn_layers.py)

RANDOM = {
    "rand": lambda P: P.rand([3, 4]),
    "randn": lambda P: P.randn([3, 4]),
    "standard_normal": lambda P: P.standard_normal([3, 4]),
    "normal": lambda P: P.normal(0.5, 2.0, [3, 4]),
    "uniform": lambda P: P.uniform([3, 4], min=-2.0, max=2.0),
    "randint": lambda P: P.randint(0, 5, [3, 4]),
    "randint_like": lambda P: P.randint_like(P.zeros([3, 4], "int32"), 5),
    "randperm": lambda P: P.randperm(6),
    "bernoulli": lambda P: P.bernoulli(P.full([3, 4], 0.5)),
    "poisson": lambda P: P.poisson(P.full([3, 4], 2.0)),
    "multinomial": lambda P: P.multinomial(P.full([2, 5], 0.2), 3),
    "gaussian": lambda P: P.gaussian([3, 4], 1.0, 0.5),
    "truncated_gaussian_random":
        lambda P: P.truncated_gaussian_random([3, 4]),
    "binomial": lambda P: P.binomial(P.full([3, 4], 5.0),
                                     P.full([3, 4], 0.3)),
    "dirichlet": lambda P: P.dirichlet(P.full([3, 4], 1.5)),
    "standard_gamma": lambda P: P.standard_gamma(P.full([3, 4], 1.5)),
    "exponential_": lambda P: P.exponential_(P.zeros([3, 4]), 2.0),
    "uniform_": lambda P: P.uniform_(P.zeros([3, 4]), 0.0, 1.0),
    "gaussian_inplace": lambda P: P.gaussian_inplace(P.zeros([3, 4])),
    "log_normal": lambda P: P.log_normal(0.0, 0.5, [3, 4]),
    "uniform_random_batch_size_like":
        lambda P: P.uniform_random_batch_size_like(P.zeros([5, 2]), [1, 3]),
    "top_p_sampling": lambda P: P.top_p_sampling(
        P.nn.functional.softmax(P.to_tensor(np.arange(10.0).reshape(2, 5)
                                            .astype(np.float32))),
        P.to_tensor(np.array([0.5, 0.9], np.float32))),
    "F.dropout": lambda P: P.nn.functional.dropout(P.ones([3, 4]), 0.5),
    "F.dropout2d": lambda P: P.nn.functional.dropout2d(P.ones([2, 3, 4, 4])),
    "F.dropout3d": lambda P: P.nn.functional.dropout3d(
        P.ones([2, 3, 2, 2, 2])),
    "F.alpha_dropout_train": lambda P: P.nn.functional.alpha_dropout(
        P.ones([3, 4]), 0.3),
    "F.feature_alpha_dropout": lambda P:
        P.nn.functional.feature_alpha_dropout(P.ones([2, 3, 4]), 0.3),
    "F.gumbel_softmax": lambda P: P.nn.functional.gumbel_softmax(
        P.zeros([3, 4]), hard=True),
    "F.rrelu": lambda P: P.nn.functional.rrelu(-P.ones([3, 4])),
    "F.class_center_sample": lambda P: P.nn.functional.class_center_sample(
        P.to_tensor(np.array([1, 3, 3])), 10, 5),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op_matches_jax_shapes_and_ranges(name):
    want = _flat(RANDOM[name](jp))
    got = _flat(RANDOM[name](tp))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype.name == w.dtype.name, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        gv, wv = _np(g), _np(w)
        assert np.isfinite(gv).all() == np.isfinite(wv).all()
        lo, hi = min(wv.min(), 0.0), max(wv.max(), 0.0)
        span = hi - lo
        assert gv.min() >= lo - 4 * span - 1e-6 and \
            gv.max() <= hi + 4 * span + 1e-6, name
