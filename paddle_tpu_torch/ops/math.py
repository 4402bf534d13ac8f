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

def _numeric(a, b):
    """JAX's numeric promotion of bool operands (torch refuses bool in
    ``-``, and integer ``//`` / ``%`` / ``**`` of two bools): a bool
    beside a non-bool tensor takes the other's dtype, two bools become
    int32, as ``jnp.subtract`` / ``floor_divide`` / ``remainder`` /
    ``power`` promote them."""
    if a.dtype == torch.bool and b.dtype == torch.bool:
        return a.to(torch.int32), b.to(torch.int32)
    if a.dtype == torch.bool:
        return a.to(b.dtype), b
    if b.dtype == torch.bool:
        return a, b.to(a.dtype)
    return a, b


def _binary_body(fn, numeric=False):
    """``fn`` on a (tensor | Python scalar) pair: scalars weakly typed
    (``_scalar_like``), then bool operands promoted when ``numeric``."""
    if numeric:
        return lambda a, b: fn(*_numeric(*_pair(a, b)))
    return lambda a, b: fn(*_pair(a, b))


def _binary(op_name, fn, numeric=False, body=None):
    body = body or _binary_body(fn, numeric)

    def op(x, y, name=None):
        return run_op(op_name, body, [x, y])
    op.__name__ = op_name
    op.body = body
    return op


def _true_divide(a, b):
    if not (a.is_floating_point() or a.is_complex() or b.is_floating_point()
            or b.is_complex()):
        dt = torch.promote_types(a.dtype, b.dtype)
        a = a.to(torch.float64 if dt == torch.int64 else torch.float32)
    return torch.true_divide(a, b)


def _sum_to(g, shape):
    """``g`` summed over the axes broadcasting added to ``shape``."""
    if tuple(g.shape) == tuple(shape):
        return g
    lead = g.dim() - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    axes = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=axes, keepdim=True) if axes else g


class _ZeroGrad(torch.autograd.Function):
    """``fn(*inputs)`` with a zero gradient in every input: what
    ``jax.grad`` gives through ``floor``-like ops (``floor_divide``) and
    through ``imag`` of a real tensor, where torch has no derivative."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.shapes = [(i.shape, i.dtype) for i in inputs]
        return fn(*inputs)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(
            g.new_zeros(s, dtype=d) if d.is_floating_point or d.is_complex
            else None for s, d in ctx.shapes)


def _zero_grad(fn, *inputs):
    if torch.is_grad_enabled() and any(i.requires_grad for i in inputs):
        return _ZeroGrad.apply(fn, *inputs)
    return fn(*inputs)


class _Heaviside(torch.autograd.Function):
    """``jnp.heaviside``: 0 below zero, 1 above, ``b`` at zero; the
    gradient reaches ``b`` where ``a == 0`` and is zero in ``a``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a)
        ctx.b_meta = (b.shape, b.dtype)
        return torch.heaviside(a, b.to(a.dtype))

    @staticmethod
    def backward(ctx, g):
        a, = ctx.saved_tensors
        shape, dt = ctx.b_meta
        gb = _sum_to(torch.where(a == 0, g, torch.zeros_like(g)), shape)
        return torch.zeros_like(a), gb.to(dt)


def _heaviside(a, b):
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Heaviside.apply(a, b)
    return torch.heaviside(a, b.to(a.dtype))


def _floor_divide(a, b):
    """``jnp.floor_divide``: XLA's integer division by zero gives -1
    (then the floor adjustment), where torch raises; a float quotient has
    a zero gradient."""
    if a.is_floating_point() or b.is_floating_point():
        return _zero_grad(torch.floor_divide, a, b)
    zero = b == 0
    safe = torch.where(zero, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    q = torch.where(zero, torch.full_like(q, -1), q)
    r = torch.where(zero, a, a - q * safe)
    fix = (torch.sign(a) != torch.sign(b)) & (r != 0)
    return torch.where(fix, q - 1, q)


def _remainder(a, b):
    """``jnp.remainder``: an integer ``x % 0`` is 0, where torch raises."""
    if a.is_floating_point() or b.is_floating_point() or a.is_complex():
        return torch.remainder(a, b)
    zero = b == 0
    r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(r), r)


def _pow_body(a, b):
    # jnp.power with a Python int exponent is lax.integer_pow of the base
    # promoted on its own: a bool base becomes int32 before the scalar
    # takes its dtype
    if isinstance(a, torch.Tensor) and a.dtype == torch.bool and \
            isinstance(b, int) and not isinstance(b, bool):
        a = a.to(torch.int32)
    return torch.pow(*_numeric(*_pair(a, b)))


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract, numeric=True)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", _true_divide)
floor_divide = _binary("floor_divide", _floor_divide, numeric=True)
remainder = _binary("remainder", _remainder, numeric=True)
mod = remainder
floor_mod = remainder
fmod = _binary("fmod", torch.fmod)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
pow_ = _binary("pow", torch.pow, body=_pow_body)
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
              else _zero_grad(torch.zeros_like, a))
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


#: f64's epsilon and -log of its largest finite value, the stopping and
#: underflow thresholds of ``_igamma_grad_a``
_EPS64 = float(np.finfo(np.float64).eps)
_LOG_TINY64 = -float(np.log(np.finfo(np.float64).max))
#: steps of ``_igamma_grad_a``'s loops between two host reads of whether
#: any element is still converging
_IGAMMA_CHECK = 16


def _igamma_grad_a(a, x):
    """d/da of the regularized lower incomplete gamma P(a, x), in f64, as
    XLA's and JAX's ``igamma_grad_a`` compute it.

    Where x > 1 and x > a it differentiates the continued fraction of
    Q = 1 - P term by term (JAX's cap of 2,000 steps); elsewhere the
    series P = x^a e^-x / Gamma(a + 1) sum_n x^n / ((a + 1)...(a + n)).
    Each element stops when its derivative's last step falls below f64's
    epsilon (relative to the sum on the series branch), and is held there
    while the others go on; the loops read the host once every
    ``_IGAMMA_CHECK`` steps. Against mpmath's derivative at 50 digits,
    on 300 log-uniform points of a in [1e-3, 1e4] and x in [1e-3, 1e5]
    and on x = a up to 1e4, the absolute error is below 1e-13. The series
    takes about 8 sqrt(a) steps near x = a (830 at a = 1e4) and fewer
    away from it; the fraction takes a few dozen. Where x^a e^-x /
    Gamma(a) underflows f64 the derivative is 0; a <= 0, x < 0 or NaN
    give NaN and x = 0 gives 0, as in JAX."""
    a64, x64 = torch.broadcast_tensors(a.double(), x.double())
    nan = torch.isnan(a64) | torch.isnan(x64) | (x64 < 0) | (a64 <= 0)
    log_ax = a64 * torch.log(x64) - x64 - torch.lgamma(a64)
    on = ~(nan | (x64 == 0) | (log_ax < _LOG_TINY64))
    one = torch.ones_like(a64)
    a64, x64 = torch.where(on, a64, one), torch.where(on, x64, one)
    ax = torch.exp(torch.where(on, log_ax, torch.zeros_like(log_ax)))
    use_cf = (x64 > 1) & (x64 > a64)
    series = _igamma_series_grad(a64, x64, on & ~use_cf)
    series = ax * series / a64
    frac = _igammac_fraction_grad(a64, x64, on & use_cf)
    out = torch.where(use_cf, -ax * frac, series)
    out = torch.where(on, out, torch.zeros_like(out))
    return torch.where(nan, torch.full_like(out, float("nan")), out)


def _igamma_series_grad(a, x, active):
    """sum_n t_n log'(t_n) of JAX's ``_igamma_series`` (t_0 = 1, t_n =
    t_(n-1) x / (a + n)) plus the prefix's log-derivative times the sum."""
    r, c, ans = a.clone(), torch.ones_like(a), torch.ones_like(a)
    dc, dans = torch.zeros_like(a), torch.zeros_like(a)
    step = 0
    while step % _IGAMMA_CHECK or bool(active.any()):
        r1 = r + 1
        dc1 = dc * (x / r1) - c * x / (r1 * r1)
        dans1 = dans + dc1
        c1 = c * (x / r1)
        r, c, dc, dans = (torch.where(active, new, old) for new, old in
                          ((r1, r), (c1, c), (dc1, dc), (dans1, dans)))
        ans = torch.where(active, ans + c1, ans)
        active = active & ((dc1 / dans1).abs() > _EPS64)
        step += 1
    return ans * (torch.log(x) - torch.digamma(a + 1)) + dans


def _igammac_fraction_grad(a, x, active):
    """d/da of Q(a, x) / (x^a e^-x / Gamma(a)) times that prefix, from
    JAX's ``_igammac_continued_fraction``: the convergents p_k / q_k and
    their derivatives in a, rescaled by epsilon when p_k grows past
    1 / epsilon."""
    y = 1 - a
    z = x + y + 1
    pkm2, qkm2, pkm1, qkm1 = torch.ones_like(x), x, x + 1, z * x
    ans = pkm1 / qkm1
    dpkm2, dqkm2, dpkm1, dqkm1 = (torch.zeros_like(x), torch.zeros_like(x),
                                  torch.zeros_like(x), -x)
    dans = (dpkm1 - ans * dqkm1) / qkm1
    for c in range(1, 2001):
        if (c - 1) % _IGAMMA_CHECK == 0 and not bool(active.any()):
            break
        y1, z1 = y + 1, z + 2
        yc = y1 * c
        pk = pkm1 * z1 - pkm2 * yc
        qk = qkm1 * z1 - qkm2 * yc
        nz = qk != 0
        ans1 = torch.where(nz, pk / qk, ans)
        dpk = dpkm1 * z1 - pkm1 - dpkm2 * yc + pkm2 * c
        dqk = dqkm1 * z1 - qkm1 - dqkm2 * yc + qkm2 * c
        dans1 = torch.where(nz, (dpk - ans1 * dqk) / qk, dans)
        moved = torch.where(nz, (dans1 - dans).abs(), torch.ones_like(dans))
        s = torch.where(pk.abs() > 1 / _EPS64, torch.full_like(pk, _EPS64),
                        torch.ones_like(pk))
        new = (ans1, y1, z1, pk * s, qk * s, pkm1 * s, qkm1 * s, dpkm1 * s,
               dqkm1 * s, dpk * s, dqk * s, dans1)
        old = (ans, y, z, pkm1, qkm1, pkm2, qkm2, dpkm2, dqkm2, dpkm1, dqkm1,
               dans)
        (ans, y, z, pkm1, qkm1, pkm2, qkm2, dpkm2, dqkm2, dpkm1, dqkm1,
         dans) = (torch.where(active, n, o) for n, o in zip(new, old))
        active = active & (moved > _EPS64)
    return ans * (torch.log(x) - torch.digamma(a)) + dans


class _Igamma(torch.autograd.Function):
    """``gammainc`` / ``gammaincc`` (``upper``) with the gradient in both
    arguments: torch has none in ``a``; see ``_igamma_grad_a``."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        f = torch.special.gammaincc if upper else torch.special.gammainc
        return f(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = _sum_to(g * (sign * _igamma_grad_a(a, x)).to(g.dtype),
                         a.shape)
        if ctx.needs_input_grad[1]:
            a64, x64 = a.double(), x.double()
            dx = torch.exp((a64 - 1) * torch.log(x64) - x64
                           - torch.lgamma(a64))
            gx = _sum_to(g * (sign * dx).to(g.dtype), x.shape)
        return ga, gx, None


def _igamma(upper):
    def body(a, x):
        a, x = _pair(a, x)
        if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad):
            return _Igamma.apply(a, x, upper)
        f = torch.special.gammaincc if upper else torch.special.gammainc
        return f(a, x)
    return body


def gammainc(x, y, name=None):
    return run_op("gammainc", _igamma(False), [x, y])


def gammaincc(x, y, name=None):
    return run_op("gammaincc", _igamma(True), [x, y])


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
    if lo is None and hi is None:       # jnp.clip(a, None, None) is a
        return run_op("clip", torch.clone, [x])
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
