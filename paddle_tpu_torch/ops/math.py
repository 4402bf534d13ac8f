"""Math ops (counterpart of ``paddle_tpu/ops/math.py``).

Each op is ``run_op`` over a torch body, under the JAX package's op
name. Python scalars stay weakly typed, as in JAX: a float scalar takes
a floating tensor's dtype, an int scalar an integer tensor's. A float
function of an integer tensor (``exp``, ``sqrt``, ``divide``, ``mean``,
...) computes in float32 for int32 and smaller, float64 for int64, as
jax.numpy promotes them.
"""
from __future__ import annotations

import builtins
import itertools

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op, run_op_nodiff, unwrap, wrap
from ..core.tensor import Tensor


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, axis):
    """A torch ``dim`` argument: every dim when ``axis`` is None."""
    ax = _axis(axis)
    return tuple(range(a.dim())) if ax is None else ax


def _scalar_like(v, ref: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-D tensor of the dtype JAX's weak typing
    gives it next to ``ref``."""
    if isinstance(v, bool):
        dt = ref.dtype
    elif isinstance(v, int):
        dt = torch.int64 if ref.dtype == torch.bool else ref.dtype
    elif isinstance(v, float):
        # next to an integer tensor JAX (x64 on) makes the weak float
        # float64, and so does the port
        dt = ref.dtype if (ref.is_floating_point() or ref.is_complex()) \
            else torch.float64
    else:
        dt = torch.complex64 if not ref.is_complex() else ref.dtype
    return torch.tensor(v, dtype=dt, device=ref.device)


def _pair(a, b):
    if not isinstance(a, torch.Tensor):
        a = _scalar_like(a, b) if isinstance(b, torch.Tensor) \
            else torch.as_tensor(a)
    if not isinstance(b, torch.Tensor):
        b = _scalar_like(b, a)
    return a, b


def _float_of(a: torch.Tensor) -> torch.Tensor:
    """``a`` in the floating dtype jax.numpy promotes it to."""
    if a.is_floating_point() or a.is_complex():
        return a
    return a.to(torch.float64 if a.dtype == torch.int64 else torch.float32)


# ---- binary elementwise ----------------------------------------------------

def _binary(op_name, fn):
    def body(a, b):
        return fn(*_pair(a, b))

    def op(x, y, name=None):
        return run_op(op_name, body, [x, y])
    op.__name__ = op_name
    return op


def _true_divide(a, b):
    if not (a.is_floating_point() or a.is_complex() or b.is_floating_point()
            or b.is_complex()):
        dt = torch.promote_types(a.dtype, b.dtype)
        a = a.to(torch.float64 if dt == torch.int64 else torch.float32)
    return torch.true_divide(a, b)


def _heaviside(a, b):
    return torch.heaviside(a, b.to(a.dtype))


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", _true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
fmod = _binary("fmod", torch.fmod)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
pow_ = _binary("pow", torch.pow)
atan2 = _binary("atan2", lambda a, b: torch.atan2(_float_of(a), b))
hypot = _binary("hypot", torch.hypot)
copysign = _binary("copysign", torch.copysign)
nextafter = _binary("nextafter", torch.nextafter)
logaddexp = _binary("logaddexp", torch.logaddexp)
heaviside = _binary("heaviside", _heaviside)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
ldexp = _binary("ldexp", lambda a, b: torch.ldexp(_float_of(a), b))


def pow(x, y, name=None):  # noqa: A001 (paddle name)
    return pow_(x, y)


def divide_int_to_float(x, y):
    return divide(x, y)


def multiply_no_nan(x, y, name=None):
    return run_op("multiply_no_nan", lambda a, b: torch.where(
        b == 0, torch.zeros((), dtype=a.dtype, device=a.device), a * b),
        [x, y])


# ---- unary elementwise -----------------------------------------------------

def _unary(op_name, fn, floating=False):
    body = (lambda a: fn(_float_of(a))) if floating else fn

    def op(x, name=None):
        return run_op(op_name, body, [x])
    op.__name__ = op_name
    return op


def _f(op_name, fn):
    return _unary(op_name, fn, floating=True)


exp = _f("exp", torch.exp)
expm1 = _f("expm1", torch.expm1)
log = _f("log", torch.log)
log2 = _f("log2", torch.log2)
log10 = _f("log10", torch.log10)
log1p = _f("log1p", torch.log1p)
sqrt = _f("sqrt", torch.sqrt)
rsqrt = _f("rsqrt", torch.rsqrt)
abs = _unary("abs", torch.abs)  # noqa: A001
absolute = abs
neg = _unary("neg", torch.neg)
negative = neg
sign = _unary("sign", torch.sign)
sgn = sign
sin = _f("sin", torch.sin)
cos = _f("cos", torch.cos)
tan = _f("tan", torch.tan)
asin = _f("asin", torch.asin)
acos = _f("acos", torch.acos)
atan = _f("atan", torch.atan)
arcsin, arccos, arctan = asin, acos, atan
sinh = _f("sinh", torch.sinh)
cosh = _f("cosh", torch.cosh)
tanh = _f("tanh", torch.tanh)
asinh = _f("asinh", torch.asinh)
acosh = _f("acosh", torch.acosh)
atanh = _f("atanh", torch.atanh)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)  # noqa: A001
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda a: a - torch.trunc(a))
square = _unary("square", torch.square)
reciprocal = _f("reciprocal", torch.reciprocal)
sigmoid = _f("sigmoid", torch.sigmoid)
erf = _f("erf", torch.erf)
erfinv = _f("erfinv", torch.erfinv)
digamma = _f("digamma", torch.digamma)
lgamma = _f("lgamma", torch.lgamma)
gammaln = lgamma
i0 = _f("i0", torch.special.i0)
i0e = _f("i0e", torch.special.i0e)
i1 = _f("i1", torch.special.i1)
i1e = _f("i1e", torch.special.i1e)
deg2rad = _f("deg2rad", torch.deg2rad)
rad2deg = _f("rad2deg", torch.rad2deg)
angle = _f("angle", torch.angle)
conj = _unary("conj", lambda a: torch.conj(a).resolve_conj())
real = _unary("real", lambda a: torch.real(a) if a.is_complex() else a)
imag = _unary("imag", lambda a: torch.imag(a) if a.is_complex()
              else torch.zeros_like(a))
exponent = _unary("exponent", lambda a: torch.frexp(a)[1].to(a.dtype))


def logit(x, eps=None, name=None):
    def fn(a):
        if eps is not None:
            a = torch.clamp(a, eps, 1.0 - eps)
        return torch.log(a / (1.0 - a))
    return run_op("logit", fn, [x])


def polygamma(x, n, name=None):
    return run_op("polygamma", lambda a: torch.polygamma(n, _float_of(a)),
                  [x])


def gammainc(x, y, name=None):
    return run_op("gammainc", torch.special.gammainc, [x, y])


def gammaincc(x, y, name=None):
    return run_op("gammaincc", torch.special.gammaincc, [x, y])


def _pred(op_name, fn):
    def op(x, name=None):
        return run_op_nodiff(op_name, fn, [x])
    op.__name__ = op_name
    return op


isnan = _pred("isnan", torch.isnan)
isinf = _pred("isinf", torch.isinf)
isfinite = _pred("isfinite", torch.isfinite)
isreal = _pred("isreal", torch.isreal)
isneginf = _pred("isneginf", torch.isneginf)
isposinf = _pred("isposinf", torch.isposinf)
signbit = _pred("signbit", torch.signbit)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return run_op("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), [x])


def clip(x, min=None, max=None, name=None):  # noqa: A002
    lo, hi = unwrap(min), unwrap(max)
    return run_op("clip", lambda a: torch.clamp(a, lo, hi), [x])


def lerp(x, y, weight, name=None):
    return run_op("lerp", lambda a, b, w: a + w * (b - a), [x, y, weight])


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return run_op("stanh", lambda a: scale_b * torch.tanh(scale_a * a), [x])


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    def fn(a, s, b):
        out = a * s + b if bias_after_scale else (a + b) * s
        return out.to(a.dtype)
    return run_op("scale", fn, [x, unwrap(scale), unwrap(bias)])


def increment(x, value=1.0, name=None):
    with torch.no_grad():
        x._data.add_(value)
    return x


# ---- reductions ------------------------------------------------------------

def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    def fn(a):
        out = torch.sum(a, dim=_dims(a, axis), keepdim=keepdim)
        if dtype is not None:
            out = out.to(dtype_mod.to_torch(dtype))
        return out
    return run_op("sum", fn, [x])


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return run_op("nansum", lambda a: torch.nansum(
        a, dim=_dims(a, axis), keepdim=keepdim), [x])


def mean(x, axis=None, keepdim=False, name=None):
    return run_op("mean", lambda a: torch.mean(
        _float_of(a), dim=_dims(a, axis), keepdim=keepdim), [x])


def nanmean(x, axis=None, keepdim=False, name=None):
    return run_op("nanmean", lambda a: torch.nanmean(
        _float_of(a), dim=_dims(a, axis), keepdim=keepdim), [x])


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return run_op("max", lambda a: torch.amax(a, dim=_dims(a, axis),
                                              keepdim=keepdim), [x])


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return run_op("min", lambda a: torch.amin(a, dim=_dims(a, axis),
                                              keepdim=keepdim), [x])


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim, name)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim, name)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    def fn(a):
        if axis is None:
            out = torch.prod(a)
            return out.reshape([1] * a.dim()) if keepdim else out
        dims = _axis(axis)
        dims = [dims] if isinstance(dims, int) else dims
        for d in sorted((d % a.dim() for d in dims), reverse=True):
            a = torch.prod(a, dim=d, keepdim=keepdim)
        return a
    return run_op("prod", fn, [x])


def logsumexp(x, axis=None, keepdim=False, name=None):
    return run_op("logsumexp", lambda a: torch.logsumexp(
        a, dim=_dims(a, axis), keepdim=keepdim), [x])


def _cum_dtype(a):
    return a.dtype if a.dtype in (torch.int32, torch.int16, torch.int8,
                                  torch.uint8) else None


def cumsum(x, axis=None, dtype=None, name=None):
    def fn(a):
        if axis is None:
            a, ax = a.reshape(-1), 0
        else:
            ax = _axis(axis)
        return torch.cumsum(a, ax, dtype=_cum_dtype(a))
    return run_op("cumsum", fn, [x])


def cumprod(x, dim=None, dtype=None, name=None):
    def fn(a):
        if dim is None:
            a, ax = a.reshape(-1), 0
        else:
            ax = _axis(dim)
        return torch.cumprod(a, ax, dtype=_cum_dtype(a))
    return run_op("cumprod", fn, [x])


def _check_cum_index_dtype(dtype):
    if str(dtype).split(".")[-1] not in ("int32", "int64"):
        raise ValueError(
            f"cummax/cummin indices dtype must be int32 or int64, got {dtype}")


def _cum_ext(op_name, fn, x, axis, dtype):
    _check_cum_index_dtype(dtype)
    want = dtype_mod.to_torch(dtype)

    def body(a):
        if axis is None:
            a, ax = a.reshape(-1), 0
        else:
            ax = _axis(axis)
        vals, idx = fn(a, ax)
        return vals, idx.to(want)
    return run_op(op_name, body, [x])


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_ext("cummax", torch.cummax, x, axis, dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_ext("cummin", torch.cummin, x, axis, dtype)


def logcumsumexp(x, axis=None, name=None):
    def fn(a):
        if axis is None:
            return torch.logcumsumexp(a.reshape(-1), 0)
        return torch.logcumsumexp(a, _axis(axis))
    return run_op("logcumsumexp", fn, [x])


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), [x])


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("diagonal", lambda a: torch.diagonal(
        a, offset, axis1, axis2), [x])


def kron(x, y, name=None):
    return run_op("kron", torch.kron, [x, y])


def inner(x, y, name=None):
    return run_op("inner", torch.inner, [x, y])


def outer(x, y, name=None):
    return run_op("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                    b.reshape(-1)), [x, y])


def dot(x, y, name=None):
    return run_op("dot", lambda a, b: torch.sum(a * b, dim=-1), [x, y])


def cross(x, y, axis=9, name=None):
    def fn(a, b):
        ax = axis
        if ax == 9:
            ax = next((i for i, s in enumerate(a.shape) if s == 3), -1)
        return torch.linalg.cross(a, b, dim=ax)
    return run_op("cross", fn, [x, y])


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return run_op("addmm", lambda i, a, b: beta * i + alpha * (a @ b),
                  [input, x, y])


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return run_op("matmul", fn, [x, y])


def mm(input, mat2, name=None):  # noqa: A002
    return run_op("matmul", torch.matmul, [input, mat2])


def bmm(x, y, name=None):
    return run_op("bmm", torch.matmul, [x, y])


def mv(x, vec, name=None):
    return run_op("mv", torch.matmul, [x, vec])


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def fn(a):
        out = torch.sum(a != 0, dim=_dims(a, axis), keepdim=keepdim)
        return out.to(torch.int64)
    return run_op_nodiff("count_nonzero", fn, [x])


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    tensors = [x] + [t for t in (prepend, append) if t is not None]

    def fn(a, *extra):
        it = iter(extra)
        pre = next(it) if prepend is not None else None
        app = next(it) if append is not None else None
        return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)
    return run_op("diff", fn, tensors)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return run_op("trapezoid", lambda yy, xx: torch.trapezoid(
            yy, xx, dim=axis), [y, x])
    return run_op("trapezoid", lambda yy: torch.trapezoid(
        yy, dx=dx or 1.0, dim=axis), [y])


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    dx = 1.0 if dx is None else dx

    def fn(yy, *rest):
        d = torch.diff(rest[0], dim=axis) if rest else dx
        n = yy.shape[axis]
        s1 = yy.narrow(axis, 1, n - 1)
        s0 = yy.narrow(axis, 0, n - 1)
        return torch.cumsum((s0 + s1) * d / 2.0, dim=axis)
    return run_op("cumulative_trapezoid", fn,
                  [y] + ([x] if x is not None else []))


def take(x, index, mode="raise", name=None):
    def fn(a, idx):
        flat = a.reshape(-1)
        n = flat.shape[0]
        if mode == "wrap":
            idx = idx % n
        elif mode == "clip":
            idx = torch.clamp(idx, 0, n - 1)
        else:
            idx = torch.where(idx < 0, idx + n, idx)
        return flat[idx]
    return run_op("take", fn, [x, index])


def renorm(x, p, axis, max_norm, name=None):
    def fn(a):
        dims = [i for i in range(a.dim()) if i != axis]
        norms = torch.sum(torch.abs(a) ** p, dim=dims,
                          keepdim=True) ** (1. / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return a * factor
    return run_op("renorm", fn, [x])


def rot90(x, k=1, axes=(0, 1), name=None):
    return run_op("rot90", lambda a: torch.rot90(a, k, list(axes)), [x])


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    a = unwrap(input).detach()
    lo, hi = (min, max) if (min != 0 or max != 0) else (
        float(a.min()), float(a.max()))
    return wrap(torch.histc(a.double(), bins, lo, hi).to(torch.int64))


def histogramdd(sample, bins=10, ranges=None, weights=None, density=False):
    a = unwrap(sample).detach().cpu().double().numpy()
    w = unwrap(weights)
    w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else w
    hist, edges = np.histogramdd(a, bins=bins, range=ranges, weights=w,
                                 density=density)
    s = unwrap(sample)
    # counts as int64, densities and edges in the sample's dtype, as
    # jnp.histogramdd gives them
    hdt = torch.int64 if w is None and not density else s.dtype
    return (wrap(torch.as_tensor(hist, device=s.device).to(hdt)),
            [wrap(torch.as_tensor(e, device=s.device).to(s.dtype))
             for e in edges])


def bincount(x, weights=None, minlength=0, name=None):
    a = unwrap(x)
    w = unwrap(weights)
    return wrap(torch.bincount(a, w, minlength=minlength))


def frexp(x, name=None):
    m, e = torch.frexp(unwrap(x))
    return wrap(m), wrap(e.to(torch.int32))


def combinations(x, r=2, with_replacement=False, name=None):
    a = unwrap(x)
    n = a.shape[0]
    it = (itertools.combinations_with_replacement(range(n), r)
          if with_replacement else itertools.combinations(range(n), r))
    idx = torch.as_tensor(list(it), dtype=torch.int64, device=a.device)
    if idx.numel() == 0:
        return wrap(a.new_zeros((0, r)))
    # not differentiable, as the JAX package's (a plain wrap)
    return run_op_nodiff("combinations", lambda v: v[idx], [x])


def vander(x, n=None, increasing=False, name=None):
    def fn(a):
        powers = range(n if n is not None else a.shape[0])
        cols = [a ** p for p in (powers if increasing else reversed(powers))]
        return torch.stack(cols, dim=-1)
    return run_op("vander", fn, [x])


def log_normalize(x, axis=-1):
    return run_op("log_normalize", lambda a: a - torch.logsumexp(
        a, dim=axis, keepdim=True), [x])


def dist(x, y, p=2.0, name=None):
    def fn(a, b):
        d = torch.abs(a - b).float()
        if p == 0:
            return torch.sum(d != 0).to(a.dtype)
        if np.isinf(p):
            return (torch.min(d) if p < 0 else torch.max(d)).to(a.dtype)
        return (torch.sum(d ** p) ** (1.0 / p)).to(a.dtype)
    return run_op("dist", fn, [x, y])


def p_norm(x, porder=2.0, axis=-1, epsilon=1e-12, keepdim=False,
           asvector=False, name=None):
    def fn(a):
        v = a.reshape(-1) if asvector else a
        ax = tuple(range(v.dim())) if asvector else axis
        d = torch.abs(v.float())
        if porder == 0:
            out = torch.sum(d != 0, dim=ax, keepdim=keepdim)
        elif np.isinf(porder):
            red = torch.amin if porder < 0 else torch.amax
            out = red(d, dim=ax, keepdim=keepdim)
        else:
            out = torch.sum(d ** porder, dim=ax,
                            keepdim=keepdim) ** (1.0 / porder)
        return out.to(a.dtype)
    return run_op("p_norm", fn, [x])


def frobenius_norm(x, axis=None, keepdim=False, name=None):
    return run_op("frobenius_norm", lambda a: torch.sqrt(torch.sum(
        torch.square(a.float()), dim=_dims(a, axis),
        keepdim=keepdim)).to(a.dtype), [x])


def l1_norm(x, name=None):
    return run_op("l1_norm", lambda a: torch.sum(torch.abs(a)), [x])


def squared_l2_norm(x, name=None):
    return run_op("squared_l2_norm", lambda a: torch.sum(torch.square(a)),
                  [x])


def clip_by_norm(x, max_norm, name=None):
    def fn(a):
        n = torch.sqrt(torch.sum(torch.square(a.float())))
        s = torch.where(n > max_norm, max_norm / torch.clamp(n, min=1e-12),
                        torch.ones_like(n))
        return (a.float() * s).to(a.dtype)
    return run_op("clip_by_norm", fn, [x])


def mean_all(x, name=None):
    return run_op("mean_all", lambda a: torch.mean(_float_of(a)), [x])


def reduce_as(x, target, name=None):
    def fn(a, t):
        extra = a.dim() - t.dim()
        out = torch.sum(a, dim=tuple(range(extra))) if extra else a
        axes = tuple(i for i, (s, ts) in enumerate(zip(out.shape, t.shape))
                     if ts == 1 != s)
        if axes:
            out = torch.sum(out, dim=axes, keepdim=True)
        return out.to(a.dtype)
    return run_op("reduce_as", fn, [x, target])


def logsigmoid(x, name=None):
    return run_op("logsigmoid", torch.nn.functional.logsigmoid, [x])


def tanh_shrink(x, name=None):
    return run_op("tanh_shrink", lambda a: a - torch.tanh(a), [x])


def multiplex(inputs, index, name=None):
    def fn(idx, *cands):
        stacked = torch.stack(cands, dim=0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.reshape(-1), rows]
    return run_op("multiplex", fn, [index] + list(inputs))


def add_n(inputs, name=None):
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]

    def fn(*xs):
        out = xs[0]
        for a in xs[1:]:
            out = out + a
        return out
    return run_op("add_n", fn, list(inputs))


def sinc(x, name=None):
    return run_op("sinc", lambda a: torch.sinc(_float_of(a)), [x])


def multigammaln(x, p, name=None):
    return run_op("multigammaln", lambda a: torch.special.multigammaln(
        a, int(p)), [x])


def positive(x, name=None):
    if unwrap(x).dtype == torch.bool:
        raise TypeError("positive is not supported for bool tensors")
    return run_op("positive", lambda b: +b, [x])


def add_position_encoding(x, alpha=1.0, beta=1.0, name=None):
    def fn(a):
        b, t, d = a.shape
        half = d // 2
        pos = torch.arange(t, dtype=torch.float32, device=a.device)[:, None]
        div = torch.pow(10000.0, torch.arange(
            half, dtype=torch.float32, device=a.device) / (half or 1))
        ang = pos / div[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        if pe.shape[-1] < d:
            pe = torch.nn.functional.pad(pe, (0, d - pe.shape[-1]))
        return alpha * a + beta * pe[None].to(a.dtype)
    return run_op("add_position_encoding", fn, [x])


def edit_distance(hyps, refs, hyp_lengths=None, ref_lengths=None,
                  normalized=True, ignored_tokens=None, name=None):
    """Levenshtein distance per sequence pair on the host (as the JAX
    package's); returns (distances [B, 1], sequence_num)."""
    h = Tensor._from_data(unwrap(hyps)).numpy()
    r = Tensor._from_data(unwrap(refs)).numpy()
    hl = np.full(h.shape[0], h.shape[1]) if hyp_lengths is None \
        else Tensor._from_data(unwrap(hyp_lengths)).numpy()
    rl = np.full(r.shape[0], r.shape[1]) if ref_lengths is None \
        else Tensor._from_data(unwrap(ref_lengths)).numpy()
    ignored = set(ignored_tokens or [])
    out = []
    for b in range(h.shape[0]):
        hs = [t for t in h[b][:hl[b]].tolist() if t not in ignored]
        rs = [t for t in r[b][:rl[b]].tolist() if t not in ignored]
        m, n = len(hs), len(rs)
        dp = np.arange(n + 1, dtype=np.float64)
        for i in range(1, m + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, n + 1):
                dp[j] = builtins.min(prev[j] + 1, dp[j - 1] + 1,
                                     prev[j - 1] + (hs[i - 1] != rs[j - 1]))
        d = dp[n]
        out.append(d / builtins.max(n, 1) if normalized else d)
    dev = unwrap(hyps).device
    return (wrap(torch.tensor(out, dtype=torch.float32,
                              device=dev).reshape(-1, 1)),
            wrap(torch.tensor([h.shape[0]], dtype=torch.int64, device=dev)))
