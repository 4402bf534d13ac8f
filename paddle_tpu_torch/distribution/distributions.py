"""paddle.distribution of the port (counterpart of
``paddle_tpu/distribution/distributions.py``; the reference's
python/paddle/distribution): 25 classes and the KL registry.

The formulas are the JAX package's, term for term, in torch. Each
density, entropy and KL takes the same inputs as there: the parameters
the JAX package passes to ``run_op`` carry gradients (the location and
scale of Normal, Uniform, Cauchy and StudentT, the probabilities or
logits of Bernoulli, Categorical, Binomial, Geometric and
ContinuousBernoulli, Exponential's rate in its KL, the mean and the
covariance of MultivariateNormal); the others are constants, as there.
``rsample`` is differentiable in the parameters for Normal, Cauchy,
ContinuousBernoulli, MultivariateNormal and Independent over them; every
other class inherits the base ``rsample``, which is ``sample``.

Draws come from the port's ``torch.Generator`` of the parameters' device
(``core.random``; ``paddle.seed`` sets it). JAX's threefry streams cannot
be reproduced, so the two packages agree on the distributions of the
samples, not on their bits. Samples and entropies keep the parameters'
floating dtype, where the JAX package's x64 defaults make some of them
float64.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Type

import numpy as np
import torch
import torch.nn.functional as F

from ..core import place as place_mod
from ..core import random as random_mod
from ..core.dispatch import run_op, unwrap, wrap
from ..core.tensor import Tensor


def _const(x) -> torch.Tensor:
    """A parameter as a constant torch tensor (a Python number is float32
    on the current place; a numpy array keeps its dtype)."""
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (int, float)):
        return torch.tensor(float(x), dtype=torch.float32,
                            device=place_mod.current_device())
    return torch.as_tensor(np.asarray(x),
                           device=place_mod.current_device())


def _input(x):
    """A parameter as a ``run_op`` input: a Tensor as it is (its gradient
    flows), anything else as a constant Tensor."""
    return x if isinstance(x, Tensor) else wrap(_const(x))


def _gen(device):
    return random_mod.generator(device)


def _fdt(*ts):
    """The floating dtype of the parameters (float32 at least)."""
    dt = torch.float32
    for t in ts:
        if t.is_floating_point():
            dt = torch.promote_types(dt, t.dtype)
    return dt


def _uniform(shp, ref, lo=0.0, hi=1.0, dtype=None):
    u = torch.rand(shp, dtype=dtype or _fdt(ref), device=ref.device,
                   generator=_gen(ref.device))
    return u * (hi - lo) + lo


def _normal(shp, ref, dtype=None):
    return torch.randn(shp, dtype=dtype or _fdt(ref), device=ref.device,
                       generator=_gen(ref.device))


def _gamma(conc, shp):
    """Standard Gamma(conc) draws of shape ``shp``."""
    c = conc.to(_fdt(conc)).expand(shp).contiguous()
    return torch._standard_gamma(c, generator=_gen(c.device))


def _bshape(*ts):
    return tuple(torch.broadcast_shapes(*[t.shape for t in ts]))


def _logsumexp_norm(logits):
    return logits - torch.logsumexp(logits, dim=-1, keepdim=True)


class Distribution:
    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        return self.sample(shape)

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return run_op("exp", torch.exp, [self.log_prob(value)])

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        # the parameters as run_op inputs: gradients flow to them
        self._loc_in, self._scale_in = _input(loc), _input(scale)
        self.loc = _const(loc)
        self.scale = _const(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return wrap(self.loc.expand(self.batch_shape))

    @property
    def variance(self):
        return wrap((self.scale ** 2).expand(self.batch_shape))

    def rsample(self, shape=()):
        """Reparameterized: loc + scale * eps, differentiable in the
        parameters."""
        shp = tuple(shape) + self.batch_shape
        eps = _normal(shp, self.loc, _fdt(self.loc))
        return run_op("normal_rsample", lambda loc, scale: loc + scale * eps,
                      [self._loc_in, self._scale_in])

    def sample(self, shape=()):
        return self.rsample(shape)

    def log_prob(self, value):
        def fn(v, loc, scale):
            var = scale ** 2
            return (-((v - loc) ** 2) / (2 * var)
                    - torch.log(scale) - 0.5 * math.log(2 * math.pi))
        return run_op("normal_log_prob", fn,
                      [value, self._loc_in, self._scale_in])

    def entropy(self):
        def fn(scale):
            return (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(scale)
                    + scale.new_zeros(self.batch_shape))
        return run_op("normal_entropy", fn, [self._scale_in])


class LogNormal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.base = Normal(loc, scale)
        super().__init__(self.base.batch_shape)

    def sample(self, shape=()):
        return run_op("exp", torch.exp, [self.base.sample(shape)])

    def log_prob(self, value):
        def fn(v):
            lv = torch.log(v)
            var = self.base.scale ** 2
            return (-((lv - self.base.loc) ** 2) / (2 * var)
                    - torch.log(self.base.scale) - lv
                    - 0.5 * math.log(2 * math.pi))
        return run_op("lognormal_log_prob", fn, [value])


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self._low_in, self._high_in = _input(low), _input(high)
        self.low = _const(low)
        self.high = _const(high)
        super().__init__(_bshape(self.low, self.high))

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        u = _uniform(shp, self.low, dtype=_fdt(self.low, self.high))
        return wrap(self.low + (self.high - self.low) * u)

    def log_prob(self, value):
        def fn(v, low, high):
            inside = (v >= low) & (v < high)
            lp = -torch.log(high - low)
            return torch.where(inside, lp, torch.full_like(lp, -math.inf))
        return run_op("uniform_log_prob", fn,
                      [value, self._low_in, self._high_in])

    def entropy(self):
        def fn(low, high):
            return torch.log(high - low) + low.new_zeros(self.batch_shape)
        return run_op("uniform_entropy", fn,
                      [self._low_in, self._high_in])


class Bernoulli(Distribution):
    def __init__(self, probs=None, logits=None, name=None):
        self._probs_in = _input(probs) if probs is not None else None
        self._logits_in = _input(logits) if logits is not None else None
        if probs is not None:
            self.probs = _const(probs)
        else:
            self.probs = torch.sigmoid(_const(logits))
        super().__init__(self.probs.shape)

    @property
    def mean(self):
        return wrap(self.probs)

    @property
    def variance(self):
        return wrap(self.probs * (1 - self.probs))

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        u = _uniform(shp, self.probs)
        return wrap((u < self.probs).to(torch.float32))

    def log_prob(self, value):
        if self._probs_in is not None:
            def fn(v, probs):
                p = torch.clamp(probs, 1e-7, 1 - 1e-7)
                return v * torch.log(p) + (1 - v) * torch.log1p(-p)
            return run_op("bernoulli_log_prob", fn,
                          [value, self._probs_in])

        def fn(v, logits):
            return (v * F.logsigmoid(logits)
                    + (1 - v) * F.logsigmoid(-logits))
        return run_op("bernoulli_log_prob", fn, [value, self._logits_in])

    def entropy(self):
        raw = self._probs_in if self._probs_in is not None \
            else self._logits_in

        def fn(r):
            p = r if self._probs_in is not None else torch.sigmoid(r)
            p = torch.clamp(p, 1e-7, 1 - 1e-7)
            return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))
        return run_op("bernoulli_entropy", fn, [raw])


def _categorical_draw(logits, shp):
    """Indices of shape ``shp`` drawn from ``logits`` [..., K] by the
    Gumbel-max trick (``shp`` ends with the logits' batch shape)."""
    u = _uniform(tuple(shp) + (logits.shape[-1],), logits,
                 dtype=_fdt(logits)).clamp_(1e-20, 1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class Categorical(Distribution):
    def __init__(self, logits=None, probs=None, name=None):
        self._logits_in = _input(logits) if logits is not None else None
        self._probs_in = _input(probs) if probs is not None else None
        if logits is not None:
            lg = _const(logits)
        else:
            lg = torch.log(torch.clamp_min(_const(probs), 1e-12))
        self.logits = _logsumexp_norm(lg)
        super().__init__(self.logits.shape[:-1])

    @property
    def probs(self):
        return wrap(torch.exp(self.logits))

    def _raw(self):
        return self._logits_in if self._logits_in is not None \
            else self._probs_in

    def _norm(self, r):
        logits = r if self._logits_in is not None else \
            torch.log(torch.clamp_min(r, 1e-12))
        return _logsumexp_norm(logits)

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        return wrap(_categorical_draw(self.logits, shp))

    def log_prob(self, value):
        def fn(v, raw):
            logits = self._norm(raw)
            idx = v.to(torch.int64)[..., None]
            shp = torch.broadcast_shapes(idx.shape[:-1], logits.shape[:-1])
            return torch.gather(logits.expand(shp + logits.shape[-1:]), -1,
                                idx.expand(shp + (1,)))[..., 0]
        return run_op("categorical_log_prob", fn, [value, self._raw()])

    def entropy(self):
        def fn(r):
            logits = self._norm(r)
            return -torch.sum(torch.exp(logits) * logits, dim=-1)
        return run_op("categorical_entropy", fn, [self._raw()])


class Exponential(Distribution):
    def __init__(self, rate, name=None):
        self._rate_in = _input(rate)
        self.rate = _const(rate)
        super().__init__(self.rate.shape)

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        e = torch.empty(shp, dtype=_fdt(self.rate), device=self.rate.device
                        ).exponential_(generator=_gen(self.rate.device))
        return wrap(e / self.rate)

    def log_prob(self, value):
        return run_op("exponential_log_prob",
                      lambda v: torch.log(self.rate) - self.rate * v,
                      [value])

    def entropy(self):
        return wrap(1.0 - torch.log(self.rate))


class Gamma(Distribution):
    def __init__(self, concentration, rate, name=None):
        self.concentration = _const(concentration)
        self.rate = _const(rate)
        super().__init__(_bshape(self.concentration, self.rate))

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        return wrap(_gamma(self.concentration, shp) / self.rate)

    def log_prob(self, value):
        def fn(v):
            a, b = self.concentration, self.rate
            return (a * torch.log(b) + (a - 1) * torch.log(v) - b * v
                    - torch.lgamma(a))
        return run_op("gamma_log_prob", fn, [value])


class Beta(Distribution):
    def __init__(self, alpha, beta, name=None):
        self.alpha = _const(alpha)
        self.beta = _const(beta)
        super().__init__(_bshape(self.alpha, self.beta))

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        x = _gamma(self.alpha, shp)
        y = _gamma(self.beta, shp)
        return wrap(x / (x + y))

    def log_prob(self, value):
        def fn(v):
            a, b = self.alpha, self.beta
            lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
            return (a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v) - lbeta
        return run_op("beta_log_prob", fn, [value])


class Dirichlet(Distribution):
    def __init__(self, concentration, name=None):
        self.concentration = _const(concentration)
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    def sample(self, shape=()):
        c = self.concentration
        shp = tuple(shape) + self.batch_shape + self.event_shape
        c = c.to(_fdt(c)).expand(shp).contiguous()
        return wrap(torch._sample_dirichlet(c, generator=_gen(c.device)))

    def log_prob(self, value):
        def fn(v):
            a = self.concentration
            lnorm = (torch.sum(torch.lgamma(a), dim=-1)
                     - torch.lgamma(torch.sum(a, dim=-1)))
            return torch.sum((a - 1) * torch.log(v), dim=-1) - lnorm
        return run_op("dirichlet_log_prob", fn, [value])


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _const(loc)
        self.scale = _const(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        u = _uniform(shp, self.loc, -1.0, 1.0).clamp(-1 + 1e-7, 1 - 1e-7)
        lap = -torch.sign(u) * torch.log1p(-torch.abs(u))
        return wrap(self.loc + self.scale * lap)

    def log_prob(self, value):
        def fn(v):
            return (-torch.abs(v - self.loc) / self.scale
                    - torch.log(2 * self.scale))
        return run_op("laplace_log_prob", fn, [value])


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _const(loc)
        self.scale = _const(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        u = _uniform(shp, self.loc).clamp(1e-20, 1.0)
        return wrap(self.loc - self.scale * torch.log(-torch.log(u)))

    def log_prob(self, value):
        def fn(v):
            z = (v - self.loc) / self.scale
            return -(z + torch.exp(-z)) - torch.log(self.scale)
        return run_op("gumbel_log_prob", fn, [value])


class Poisson(Distribution):
    def __init__(self, rate, name=None):
        self.rate = _const(rate)
        super().__init__(self.rate.shape)

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        r = self.rate.to(_fdt(self.rate)).expand(shp).contiguous()
        return wrap(torch.poisson(r, generator=_gen(r.device)))

    def log_prob(self, value):
        def fn(v):
            return (v * torch.log(self.rate) - self.rate
                    - torch.lgamma(v + 1))
        return run_op("poisson_log_prob", fn, [value])


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        self.probs_a = _const(probs)
        super().__init__(self.probs_a.shape[:-1],
                         self.probs_a.shape[-1:])

    def sample(self, shape=()):
        logits = torch.log(torch.clamp_min(self.probs_a, 1e-12))
        cat = _categorical_draw(logits, tuple(shape) + (self.total_count,)
                                + self.batch_shape)
        k = self.probs_a.shape[-1]
        onehot = F.one_hot(cat, k).to(_fdt(self.probs_a))
        return wrap(torch.sum(onehot, dim=len(shape)))

    def log_prob(self, value):
        def fn(v):
            logp = torch.log(torch.clamp_min(self.probs_a, 1e-12))
            coef = (torch.lgamma(torch.sum(v, -1) + 1)
                    - torch.sum(torch.lgamma(v + 1), -1))
            return coef + torch.sum(v * logp, dim=-1)
        return run_op("multinomial_log_prob", fn, [value])


class TransformedDistribution(Distribution):
    """A base distribution pushed through transforms (sampling)."""

    def __init__(self, base, transforms):
        self.base = base
        self.transforms = transforms if isinstance(transforms, list) \
            else [transforms]
        super().__init__(base.batch_shape, base.event_shape)

    def sample(self, shape=()):
        x = self.base.sample(shape)
        for t in self.transforms:
            x = t.forward(x)
        return x


# -- KL registry -------------------------------------------------------------

_KL_REGISTRY: Dict[Tuple[Type, Type], callable] = {}


def register_kl(p_cls, q_cls):
    """Decorator registering the KL of a pair of classes."""
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn
    return deco


def kl_divergence(p: Distribution, q: Distribution):
    for (pc, qc), fn in _KL_REGISTRY.items():
        if isinstance(p, pc) and isinstance(q, qc):
            return fn(p, q)
    raise NotImplementedError(
        f"no KL registered for ({type(p).__name__}, {type(q).__name__})")


@register_kl(Normal, Normal)
def _kl_normal_normal(p, q):
    def fn(pl, ps, ql, qs):
        var_ratio = (ps / qs) ** 2
        t1 = ((pl - ql) / qs) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    return run_op("kl_normal_normal", fn,
                  [p._loc_in, p._scale_in, q._loc_in, q._scale_in])


@register_kl(Uniform, Uniform)
def _kl_uniform_uniform(p, q):
    def fn(pl, ph, ql, qh):
        return torch.log((qh - ql) / (ph - pl))
    return run_op("kl_uniform_uniform", fn,
                  [p._low_in, p._high_in, q._low_in, q._high_in])


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli_bernoulli(p, q):
    def to_probs(d, r):
        pr = r if d._probs_in is not None else torch.sigmoid(r)
        return torch.clamp(pr, 1e-7, 1 - 1e-7)

    def fn(pr_raw, qr_raw):
        pp = to_probs(p, pr_raw)
        qq = to_probs(q, qr_raw)
        return (pp * torch.log(pp / qq)
                + (1 - pp) * torch.log((1 - pp) / (1 - qq)))
    pr = p._probs_in if p._probs_in is not None else p._logits_in
    qr = q._probs_in if q._probs_in is not None else q._logits_in
    return run_op("kl_bernoulli_bernoulli", fn, [pr, qr])


@register_kl(Categorical, Categorical)
def _kl_categorical_categorical(p, q):
    def fn(pr_raw, qr_raw):
        pl = p._norm(pr_raw)
        ql = q._norm(qr_raw)
        return torch.sum(torch.exp(pl) * (pl - ql), dim=-1)
    return run_op("kl_categorical_categorical", fn, [p._raw(), q._raw()])


@register_kl(Exponential, Exponential)
def _kl_exponential_exponential(p, q):
    def fn(pr, qr):
        return torch.log(pr / qr) + qr / pr - 1
    return run_op("kl_exponential_exponential", fn,
                  [p._rate_in, q._rate_in])


class ExponentialFamily(Distribution):
    """Base of the exponential families: ``entropy`` from the
    log-normalizer by autograd (the Bregman identity), as the JAX package
    computes it with ``jax.grad``."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        return 0.0

    def entropy(self):
        with torch.enable_grad():
            nat = [_const(p).to(torch.float32).requires_grad_(True)
                   for p in self._natural_parameters]
            lg = self._log_normalizer(*nat)
            grads = torch.autograd.grad(lg.sum(), nat)
        ent = lg.detach() - self._mean_carrier_measure
        for p, g in zip(nat, grads):
            ent = ent - p.detach() * g
        return wrap(ent)


class Binomial(Distribution):
    """Binomial(total_count, probs)."""

    def __init__(self, total_count, probs, name=None):
        self._probs_in = _input(probs)
        self.total_count = _const(total_count).to(torch.int32)
        self.probs = _const(probs)
        super().__init__(_bshape(self.total_count, self.probs))

    @property
    def mean(self):
        return wrap(self.total_count * self.probs)

    @property
    def variance(self):
        return wrap(self.total_count * self.probs * (1 - self.probs))

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        dt = _fdt(self.probs)
        n = self.total_count.to(dt).expand(shp).contiguous()
        p = self.probs.to(dt).expand(shp).contiguous()
        return wrap(torch.binomial(n, p, generator=_gen(p.device)).to(
            torch.float32))

    def log_prob(self, value):
        def fn(v, p):
            n = self.total_count.to(v.dtype if v.is_floating_point()
                                    else p.dtype)
            comb = (torch.lgamma(n + 1) - torch.lgamma(v + 1)
                    - torch.lgamma(n - v + 1))
            return comb + v * torch.log(p) + (n - v) * torch.log1p(-p)
        return run_op("binomial_log_prob", fn, [value, self._probs_in])

    def entropy(self):
        # an explicit sum over the support, as the reference kernel does
        n_max = int(self.total_count.max())
        ks = torch.arange(n_max + 1, dtype=torch.float32,
                          device=self.probs.device)

        def fn(p):
            n = self.total_count.expand(self.batch_shape).to(torch.float32)
            k = ks.reshape((-1,) + (1,) * len(self.batch_shape))
            comb = (torch.lgamma(n + 1) - torch.lgamma(k + 1)
                    - torch.lgamma(n - k + 1))
            logp = comb + k * torch.log(p) + (n - k) * torch.log1p(-p)
            logp = torch.where(k <= n, logp, torch.full_like(logp, -math.inf))
            pk = torch.exp(logp)
            return -torch.sum(torch.where(pk > 0, pk * logp,
                                          torch.zeros_like(pk)), dim=0)
        return run_op("binomial_entropy", fn, [self._probs_in])


class Cauchy(Distribution):
    """Cauchy(loc, scale)."""

    def __init__(self, loc, scale, name=None):
        self._loc_in, self._scale_in = _input(loc), _input(scale)
        self.loc = _const(loc)
        self.scale = _const(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def rsample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        u = _uniform(shp, self.loc, 1e-7, 1 - 1e-7)

        def fn(loc, scale):
            return loc + scale * torch.tan(math.pi * (u - 0.5))
        return run_op("cauchy_rsample", fn, [self._loc_in, self._scale_in])

    def sample(self, shape=()):
        return self.rsample(shape)

    def log_prob(self, value):
        def fn(v, loc, scale):
            z = (v - loc) / scale
            return -torch.log(math.pi * scale * (1 + z * z))
        return run_op("cauchy_log_prob", fn,
                      [value, self._loc_in, self._scale_in])

    def cdf(self, value):
        def fn(v, loc, scale):
            return torch.atan((v - loc) / scale) / math.pi + 0.5
        return run_op("cauchy_cdf", fn,
                      [value, self._loc_in, self._scale_in])

    def entropy(self):
        def fn(scale):
            return (torch.log(4 * math.pi * scale)
                    + scale.new_zeros(self.batch_shape))
        return run_op("cauchy_entropy", fn, [self._scale_in])


class Chi2(Gamma):
    """Chi-squared: Gamma(df / 2, rate 1 / 2)."""

    def __init__(self, df, name=None):
        self.df = _const(df)
        super().__init__(self.df / 2.0, 0.5)


class ContinuousBernoulli(Distribution):
    """The continuous Bernoulli on [0, 1]."""

    def __init__(self, probs, lims=(0.499, 0.501), name=None):
        self._probs_in = _input(probs)
        self.probs = _const(probs)
        self._lims = lims
        super().__init__(self.probs.shape)

    def _near_half(self, lam):
        lo, hi = self._lims
        return (lam > lo) & (lam < hi)

    def _log_C(self, lam):
        # the log normalizing constant; its removable singularity at 1/2
        # is replaced by a Taylor expansion, as in the reference
        near = self._near_half(lam)
        safe = torch.where(near, torch.full_like(lam, 0.25), lam)
        logc = torch.log((2 * torch.atanh(1 - 2 * safe)) / (1 - 2 * safe))
        taylor = math.log(2.0) + 4.0 / 3.0 * (lam - 0.5) ** 2
        return torch.where(near, taylor, logc)

    @property
    def mean(self):
        lam = self.probs
        near = self._near_half(lam)
        safe = torch.where(near, torch.full_like(lam, 0.25), lam)
        m = safe / (2 * safe - 1) + 1 / (2 * torch.atanh(1 - 2 * safe))
        return wrap(torch.where(near, torch.full_like(m, 0.5), m))

    def rsample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        u = _uniform(shp, self.probs, 1e-6, 1 - 1e-6)

        def fn(lam):
            near = self._near_half(lam)
            safe = torch.where(near, torch.full_like(lam, 0.25), lam)
            x = (torch.log1p(u * (2 * safe - 1) / (1 - safe))
                 / (torch.log(safe) - torch.log1p(-safe)))
            return torch.where(near, u.expand_as(x), x)
        return run_op("cb_rsample", fn, [self._probs_in])

    def sample(self, shape=()):
        return self.rsample(shape)

    def log_prob(self, value):
        def fn(v, lam):
            return (v * torch.log(lam) + (1 - v) * torch.log1p(-lam)
                    + self._log_C(lam))
        return run_op("cb_log_prob", fn, [value, self._probs_in])


class Geometric(Distribution):
    """Geometric(probs) on {0, 1, ...}: pmf (1 - p)^k p."""

    def __init__(self, probs, name=None):
        self._probs_in = _input(probs)
        self.probs = _const(probs)
        super().__init__(self.probs.shape)

    @property
    def mean(self):
        return wrap((1 - self.probs) / self.probs)

    @property
    def variance(self):
        return wrap((1 - self.probs) / self.probs ** 2)

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        u = _uniform(shp, self.probs, 1e-7, 1 - 1e-7)
        return run_op("geometric_sample", lambda p: torch.floor(
            torch.log1p(-u) / torch.log1p(-p)), [self._probs_in])

    def log_prob(self, value):
        def fn(v, p):
            return v * torch.log1p(-p) + torch.log(p)
        return run_op("geometric_log_prob", fn, [value, self._probs_in])

    def entropy(self):
        def fn(p):
            q = 1 - p
            return -(q * torch.log(q) + p * torch.log(p)) / p
        return run_op("geometric_entropy", fn, [self._probs_in])

    def cdf(self, value):
        def fn(v, p):
            return 1 - torch.pow(1 - p, v + 1)
        return run_op("geometric_cdf", fn, [value, self._probs_in])


def _sum_last(a, k):
    return torch.sum(a, dim=tuple(range(a.dim() - k, a.dim())))


class Independent(Distribution):
    """Reinterprets the base's last batch dims as event dims."""

    def __init__(self, base, reinterpreted_batch_rank, name=None):
        self.base = base
        self.reinterpreted_batch_rank = int(reinterpreted_batch_rank)
        bs = base.batch_shape
        k = self.reinterpreted_batch_rank
        if k > len(bs):
            raise ValueError(
                "reinterpreted_batch_rank exceeds base batch rank")
        super().__init__(bs[:len(bs) - k],
                         bs[len(bs) - k:] + tuple(base.event_shape))

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance

    def sample(self, shape=()):
        return self.base.sample(shape)

    def rsample(self, shape=()):
        return self.base.rsample(shape)

    def log_prob(self, value):
        lp = self.base.log_prob(value)
        k = self.reinterpreted_batch_rank
        if k == 0:
            return lp
        return run_op("independent_log_prob", lambda a: _sum_last(a, k),
                      [lp])

    def entropy(self):
        ent = self.base.entropy()
        k = self.reinterpreted_batch_rank
        if k == 0:
            return ent
        return run_op("independent_entropy", lambda a: _sum_last(a, k),
                      [ent])


class MultivariateNormal(Distribution):
    """The multivariate normal through its Cholesky factor. Exactly one of
    covariance_matrix / precision_matrix / scale_tril is given; the raw
    one is the ``run_op`` input, so gradients reach it through the
    Cholesky and the inverse."""

    def __init__(self, loc, covariance_matrix=None, precision_matrix=None,
                 scale_tril=None, name=None):
        given = [a is not None for a in (covariance_matrix,
                                         precision_matrix, scale_tril)]
        if sum(given) != 1:
            raise ValueError("pass exactly one of covariance_matrix, "
                             "precision_matrix, scale_tril")
        self._loc_in = _input(loc)
        self.loc = _const(loc)
        if scale_tril is not None:
            raw, self._cov_form = scale_tril, "tril"
        elif covariance_matrix is not None:
            raw, self._cov_form = covariance_matrix, "cov"
        else:
            raw, self._cov_form = precision_matrix, "prec"
        self._cov_in = _input(raw)
        self.scale_tril = self._to_tril(_const(raw))
        d = self.loc.shape[-1]
        super().__init__(torch.broadcast_shapes(
            self.loc.shape[:-1], self.scale_tril.shape[:-2]), (d,))

    @property
    def mean(self):
        return wrap(self.loc.expand(self.batch_shape + self.event_shape))

    @property
    def covariance_matrix(self):
        return wrap(self.scale_tril @ self.scale_tril.transpose(-2, -1))

    @property
    def variance(self):
        return wrap(torch.sum(self.scale_tril ** 2, dim=-1).expand(
            self.batch_shape + self.event_shape))

    def _to_tril(self, raw):
        if self._cov_form == "tril":
            return raw
        if self._cov_form == "cov":
            return torch.linalg.cholesky(raw)
        return torch.linalg.cholesky(torch.linalg.inv(raw))

    def rsample(self, shape=()):
        shp = tuple(shape) + self.batch_shape + self.event_shape
        eps = _normal(shp, self.loc, torch.float32)

        def fn(loc, cov_raw):
            L = self._to_tril(cov_raw)
            return loc + torch.einsum("...ij,...j->...i", L,
                                      eps.to(L.dtype))
        return run_op("mvn_rsample", fn, [self._loc_in, self._cov_in])

    def sample(self, shape=()):
        return self.rsample(shape)

    def log_prob(self, value):
        def fn(v, loc, cov_raw):
            L = self._to_tril(cov_raw)
            d = v.shape[-1]
            diff = v - loc
            Lb = L.expand(diff.shape[:-1] + L.shape[-2:])
            z = torch.linalg.solve_triangular(Lb, diff[..., None],
                                              upper=False)[..., 0]
            half_logdet = torch.sum(torch.log(torch.abs(
                torch.diagonal(L, dim1=-2, dim2=-1))), -1)
            return (-0.5 * torch.sum(z * z, -1) - half_logdet
                    - 0.5 * d * math.log(2 * math.pi))
        return run_op("mvn_log_prob", fn,
                      [value, self._loc_in, self._cov_in])

    def entropy(self):
        d = self.event_shape[0]
        half_logdet = torch.sum(torch.log(torch.abs(
            torch.diagonal(self.scale_tril, dim1=-2, dim2=-1))), -1)
        ent = 0.5 * d * (1 + math.log(2 * math.pi)) + half_logdet
        return wrap(ent.expand(self.batch_shape))


class StudentT(Distribution):
    """Student's t."""

    def __init__(self, df, loc=0.0, scale=1.0, name=None):
        self._df_in, self._loc_in, self._scale_in = \
            _input(df), _input(loc), _input(scale)
        self.df = _const(df)
        self.loc = _const(loc)
        self.scale = _const(scale)
        super().__init__(_bshape(self.df, self.loc, self.scale))

    @property
    def mean(self):
        m = self.loc.expand(self.batch_shape)
        return wrap(torch.where(self.df > 1, m, torch.full_like(m, math.nan)))

    @property
    def variance(self):
        df = self.df
        v = torch.where(df > 2, df / (df - 2), torch.full_like(df, math.inf))
        v = torch.where(df > 1, v, torch.full_like(v, math.nan))
        return wrap((self.scale ** 2 * v).expand(self.batch_shape))

    def sample(self, shape=()):
        shp = tuple(shape) + self.batch_shape
        df = self.df.to(_fdt(self.df)).expand(shp)
        z = _normal(shp, df)
        chi2 = 2.0 * _gamma(df / 2.0, shp)
        t = z / torch.sqrt(chi2 / df)

        def fn(df_, loc, scale):
            return loc + scale * t
        return run_op("student_t_sample", fn,
                      [self._df_in, self._loc_in, self._scale_in])

    def log_prob(self, value):
        def fn(v, df, loc, scale):
            z = (v - loc) / scale
            return (torch.lgamma((df + 1) / 2) - torch.lgamma(df / 2)
                    - 0.5 * torch.log(df * math.pi) - torch.log(scale)
                    - (df + 1) / 2 * torch.log1p(z * z / df))
        return run_op("student_t_log_prob", fn,
                      [value, self._df_in, self._loc_in, self._scale_in])

    def entropy(self):
        def fn(df, scale):
            half = (df + 1) / 2
            betaln = (torch.lgamma(df / 2) + math.lgamma(0.5)
                      - torch.lgamma(df / 2 + 0.5))
            return (torch.log(scale) + 0.5 * torch.log(df) + betaln
                    + half * (torch.digamma(half) - torch.digamma(df / 2)))
        return run_op("student_t_entropy", fn,
                      [self._df_in, self._scale_in])


class LKJCholesky(Distribution):
    """The LKJ prior over Cholesky factors of correlation matrices:
    sampled by the onion method, its density the standard LKJ density on
    L (the normaliser in multivariate-gamma form)."""

    def __init__(self, dim, concentration=1.0, sample_method="onion",
                 name=None):
        if dim < 2:
            raise ValueError("dim must be >= 2")
        if sample_method not in ("onion", "cvine"):
            raise ValueError("sample_method must be 'onion' or 'cvine'")
        self.dim = int(dim)
        self.concentration = _const(concentration)
        self.sample_method = sample_method
        super().__init__(self.concentration.shape, (self.dim, self.dim))

    def sample(self, shape=()):
        # the onion method: row by row from Beta marginals and spheres
        d = self.dim
        shp = tuple(shape) + self.batch_shape
        eta = self.concentration.to(torch.float32).expand(shp)
        L = eta.new_zeros(shp + (d, d))
        L[..., 0, 0] = 1.0
        beta = eta + (d - 2) / 2.0
        for i in range(1, d):
            x = _gamma(torch.full_like(beta, i / 2.0), shp)
            y = _gamma(beta, shp)
            b = x / (x + y)
            beta = beta - 0.5
            u = _normal(shp + (i,), eta, torch.float32)
            u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
            L[..., i, :i] = torch.sqrt(b)[..., None] * u
            L[..., i, i] = torch.sqrt(torch.clamp_min(1 - b, 1e-12))
        return wrap(L)

    def log_prob(self, value):
        def fn(L, eta):
            d = self.dim
            diag = torch.diagonal(L, dim1=-2, dim2=-1)[..., 1:]
            orders = torch.arange(2, d + 1, dtype=torch.float32,
                                  device=L.device)
            exponents = 2 * (eta[..., None] - 1) + d - orders
            unnorm = torch.sum(exponents * torch.log(diag), dim=-1)
            dm1 = d - 1
            alpha = eta + 0.5 * dm1
            norm = (0.5 * dm1 * math.log(math.pi)
                    + torch.special.multigammaln(alpha - 0.5, dm1)
                    - dm1 * torch.lgamma(alpha))
            return unnorm - norm
        return run_op("lkj_log_prob", fn,
                      [value, wrap(self.concentration.to(torch.float32))])
