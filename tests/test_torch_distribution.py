"""The port's ``distribution`` against the JAX package's on the same seeded
inputs: every class's ``log_prob`` / ``prob`` / ``entropy`` / ``mean`` /
``variance`` / ``cdf``, the five registered KL pairs and every transform,
values and input gradients within the f32 gate (``MultivariateNormal``
and ``LKJCholesky`` also in f64). JAX's threefry draws cannot be
reproduced, so the samples are held to their distributions (means and
variances within 4 standard errors), to reproducibility under ``seed``,
and the five reparameterised ``rsample``s to finite gradients."""
import math

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_place")


def pos(*shape, seed=0, lo=0.5, hi=2.0):
    return arr(*shape, seed=seed, lo=lo, hi=hi)


def prob(*shape, seed=0):
    return arr(*shape, seed=seed, lo=0.1, hi=0.9)


# name -> (ctor(D, *params), params, value, methods)
_CASES = {
    "Normal": (lambda D, a, b: D.Normal(a, b), [arr(2, 3, seed=1),
               pos(2, 3, seed=2)], arr(2, 3, seed=3),
               ("log_prob", "prob", "entropy", "mean", "variance")),
    "LogNormal": (lambda D, a, b: D.LogNormal(a, b), [arr(3, seed=4),
                  pos(3, seed=5)], pos(3, seed=6), ("log_prob",)),
    "Uniform": (lambda D, a, b: D.Uniform(a, b), [arr(4, seed=7, lo=-1,
                hi=0), pos(4, seed=8)], np.array([-0.5, 0.2, 1.9, -2.0],
                                                 np.float32),
                ("log_prob", "entropy")),
    "Bernoulli": (lambda D, p: D.Bernoulli(p), [prob(4, seed=9)],
                  np.array([0, 1, 1, 0], np.float32),
                  ("log_prob", "entropy", "mean", "variance")),
    "BernoulliLogits": (lambda D, lg: D.Bernoulli(logits=lg),
                        [arr(4, seed=10)], np.array([1, 0, 1, 1],
                                                    np.float32),
                        ("log_prob", "entropy", "mean")),
    "Categorical": (lambda D, lg: D.Categorical(lg), [arr(3, 5, seed=11)],
                    np.array([0, 4, 2], np.int64),
                    ("log_prob", "entropy", "probs")),
    "CategoricalProbs": (lambda D, p: D.Categorical(probs=p),
                         [prob(3, 5, seed=12)], np.array([1, 3, 0], np.int64),
                         ("log_prob", "entropy")),
    "Exponential": (lambda D, r: D.Exponential(r), [pos(4, seed=13)],
                    pos(4, seed=14), ("log_prob", "entropy")),
    "Gamma": (lambda D, a, b: D.Gamma(a, b), [pos(4, seed=15),
              pos(4, seed=16)], pos(4, seed=17), ("log_prob",)),
    "Chi2": (lambda D, k: D.Chi2(k), [pos(4, seed=18, lo=1, hi=5)],
             pos(4, seed=19), ("log_prob",)),
    "Beta": (lambda D, a, b: D.Beta(a, b), [pos(4, seed=20),
             pos(4, seed=21)], prob(4, seed=22), ("log_prob",)),
    "Dirichlet": (lambda D, c: D.Dirichlet(c), [pos(2, 4, seed=23)],
                  np.array([[.1, .2, .3, .4], [.25, .25, .25, .25]],
                           np.float32), ("log_prob",)),
    "Laplace": (lambda D, a, b: D.Laplace(a, b), [arr(4, seed=24),
                pos(4, seed=25)], arr(4, seed=26), ("log_prob",)),
    "Gumbel": (lambda D, a, b: D.Gumbel(a, b), [arr(4, seed=27),
               pos(4, seed=28)], arr(4, seed=29), ("log_prob",)),
    "Poisson": (lambda D, r: D.Poisson(r), [pos(4, seed=30, hi=5)],
                np.array([0, 1, 3, 7], np.float32), ("log_prob",)),
    "Multinomial": (lambda D, p: D.Multinomial(6, p), [np.array(
        [[.2, .3, .5], [.6, .3, .1]], np.float32)],
        np.array([[1, 2, 3], [4, 1, 1]], np.float32), ("log_prob",)),
    "Binomial": (lambda D, p: D.Binomial(np.array([5, 8, 3], np.int64), p),
                 [prob(3, seed=31)], np.array([2, 8, 0], np.float32),
                 ("log_prob", "entropy", "mean", "variance")),
    "Cauchy": (lambda D, a, b: D.Cauchy(a, b), [arr(4, seed=32),
               pos(4, seed=33)], arr(4, seed=34, lo=-3, hi=3),
               ("log_prob", "entropy", "cdf")),
    "ContinuousBernoulli": (lambda D, p: D.ContinuousBernoulli(p), [np.array(
        [0.2, 0.4995, 0.5003, 0.8], np.float32)], prob(4, seed=35),
        ("log_prob", "mean")),
    "Geometric": (lambda D, p: D.Geometric(p), [prob(4, seed=36)],
                  np.array([0, 1, 2, 5], np.float32),
                  ("log_prob", "entropy", "cdf", "mean", "variance")),
    "StudentT": (lambda D, df, a, b: D.StudentT(df, a, b), [pos(
        4, seed=37, lo=3, hi=8), arr(4, seed=38), pos(4, seed=39)],
        arr(4, seed=40, lo=-3, hi=3),
        ("log_prob", "entropy", "mean", "variance")),
    "Independent": (lambda D, a, b: D.Independent(D.Normal(a, b), 1),
                    [arr(2, 3, seed=41), pos(2, 3, seed=42)],
                    arr(2, 3, seed=43), ("log_prob", "entropy", "mean")),
    "MVNTril": (lambda D, m, L: D.MultivariateNormal(m, scale_tril=L),
                [arr(3, seed=44), np.tril(arr(3, 3, seed=45)) + 2 * np.eye(
                    3, dtype=np.float32)], arr(3, seed=46),
                ("log_prob", "entropy", "mean", "variance")),
}


def _method(pkg, name, meth):
    ctor = _CASES[name][0]

    def f(v, *ps):
        d = ctor(pkg.distribution, *ps)
        attr = getattr(d, meth)
        return attr(v) if meth in ("log_prob", "prob", "cdf") else (
            attr() if callable(attr) else attr)
    return f


_METHOD_CASES = [(n, m) for n in sorted(_CASES) for m in _CASES[n][3]]


@pytest.mark.parametrize("name,meth", _METHOD_CASES)
def test_distribution_methods_match_jax(name, meth):
    _, params, value, _ = _CASES[name]
    ints = tuple(i for i, a in enumerate([value] + params)
                 if np.asarray(a).dtype.kind in "iu")
    run_both(_method(jp, name, meth), _method(tp, name, meth),
             [value] + params, gate=True, int_args=ints)


def _spd(d, seed, dtype):
    a = np.random.default_rng(seed).standard_normal((d, d))
    return (a @ a.T / d + np.eye(d)).astype(dtype)


@pytest.mark.parametrize("form", ["covariance_matrix", "precision_matrix",
                                  "scale_tril"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_multivariate_normal_log_prob(form, dtype):
    d = 8
    cov = _spd(d, 50, dtype)
    if form == "scale_tril":
        cov = np.linalg.cholesky(cov).astype(dtype)
    loc = np.random.default_rng(51).standard_normal(d).astype(dtype)
    v = np.random.default_rng(52).standard_normal((5, d)).astype(dtype)
    outs = {}
    for pkg in (jp, tp):
        ts = [pkg.to_tensor(a, dtype=dtype, stop_gradient=False)
              for a in (loc, cov)]
        dist = pkg.distribution.MultivariateNormal(ts[0], **{form: ts[1]})
        lp = [dist.log_prob(pkg.to_tensor(v[i], dtype=dtype))
              for i in range(5)]
        total = sum(x.sum() for x in lp)
        total.backward()
        outs[pkg] = ([x.numpy() for x in lp], [t.grad.numpy() for t in ts],
                     dist.entropy().numpy())
    tol = 1e-4 if dtype == "float32" else 1e-10
    for a, b in zip(outs[tp][0] + outs[tp][1] + [outs[tp][2]],
                    outs[jp][0] + outs[jp][1] + [outs[jp][2]]):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lkj_cholesky_log_prob(dtype):
    d = 4
    corr = _spd(d, 53, "float64")
    s = np.sqrt(np.diag(corr))
    L = np.linalg.cholesky(corr / np.outer(s, s)).astype(dtype)
    for eta in (0.5, 1.0, 2.5):
        vals = []
        for pkg in (jp, tp):
            lkj = pkg.distribution.LKJCholesky(d, eta)
            vals.append(lkj.log_prob(pkg.to_tensor(L, dtype=dtype)).numpy())
        np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5, atol=1e-5)


_KL = {
    "Normal": lambda D, a, b, c, d: (D.Normal(a, b), D.Normal(c, d)),
    "Uniform": lambda D, a, b, c, d: (D.Uniform(a * 0.1, b + 1.0),
                                      D.Uniform(a * 0.1 - 1.0, b + 2.0)),
    "Bernoulli": lambda D, a, b, c, d: (D.Bernoulli(b * 0.4),
                                        D.Bernoulli(logits=c)),
    "Categorical": lambda D, a, b, c, d: (D.Categorical(a),
                                          D.Categorical(probs=b)),
    "Exponential": lambda D, a, b, c, d: (D.Exponential(b),
                                          D.Exponential(d)),
}


@pytest.mark.parametrize("pair", sorted(_KL))
def test_registered_kl_pairs(pair):
    ps = [arr(3, 4, seed=60), pos(3, 4, seed=61), arr(3, 4, seed=62),
          pos(3, 4, seed=63)]

    def fn(pkg):
        def f(*xs):
            p, q = _KL[pair](pkg.distribution, *xs)
            return pkg.distribution.kl_divergence(p, q), p.kl_divergence(q)
        return f
    run_both(fn(jp), fn(tp), ps, gate=True)


def test_register_kl_and_missing_pair():
    D = tp.distribution

    class Mine(D.Normal):
        pass

    @D.register_kl(Mine, D.Laplace)
    def _kl(p, q):
        return tp.to_tensor(7.0)

    assert float(D.kl_divergence(Mine(0.0, 1.0), D.Laplace(0.0, 1.0))) == 7.0
    with pytest.raises(NotImplementedError):
        D.kl_divergence(D.Gamma(1.0, 1.0), D.Beta(1.0, 1.0))
    assert D.kl.kl_divergence is D.kl_divergence
    assert D.chi2.Chi2 is D.Chi2 and D.lkj_cholesky.LKJCholesky is \
        D.LKJCholesky


def test_exponential_family_entropy_by_autograd():
    def build(pkg):
        class NormalEF(pkg.distribution.ExponentialFamily):
            def __init__(self, loc, scale):
                self.loc, self.scale = loc, scale
                super().__init__((3,))

            @property
            def _natural_parameters(self):
                return (self.loc / self.scale ** 2,
                        -0.5 / self.scale ** 2)

            def _log_normalizer(self, x, y):
                return -0.25 * x ** 2 / y + 0.5 * _log(pkg, -math.pi / y)

            @property
            def _mean_carrier_measure(self):
                return 0.0
        return NormalEF
    loc = np.array([0.1, -0.3, 0.7], np.float32)
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    got = build(tp)(loc, scale).entropy().numpy()
    ref = build(jp)(loc, scale).entropy().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, 0.5 + 0.5 * np.log(2 * np.pi)
                               + np.log(scale), rtol=1e-5)


def _log(pkg, x):
    if pkg is jp:
        import jax.numpy as jnp
        return jnp.log(x)
    import torch
    return torch.log(x)


# -- sampling ------------------------------------------------------------------

N_SAMPLES = 20000

_SAMPLE = {
    "Normal": (lambda D: D.Normal(np.float32(0.5), np.float32(2.0)),
               0.5, 4.0),
    "LogNormal": (lambda D: D.LogNormal(np.float32(0.1), np.float32(0.4)),
                  math.exp(0.1 + 0.08),
                  (math.exp(0.16) - 1) * math.exp(0.2 + 0.16)),
    "Uniform": (lambda D: D.Uniform(np.float32(-1.0), np.float32(3.0)),
                1.0, 16 / 12),
    "Bernoulli": (lambda D: D.Bernoulli(np.float32(0.3)), 0.3, 0.21),
    "Categorical": (lambda D: D.Categorical(np.log(np.array(
        [0.2, 0.5, 0.3], np.float32))), 1.1, 0.49),
    "Exponential": (lambda D: D.Exponential(np.float32(2.0)), 0.5, 0.25),
    "Gamma": (lambda D: D.Gamma(np.float32(3.0), np.float32(2.0)),
              1.5, 0.75),
    "Chi2": (lambda D: D.Chi2(np.float32(4.0)), 4.0, 8.0),
    "Beta": (lambda D: D.Beta(np.float32(2.0), np.float32(3.0)),
             0.4, 0.04),
    "Dirichlet": (lambda D: D.Dirichlet(np.array([2.0, 3.0], np.float32)),
                  np.array([0.4, 0.6]), np.array([0.04, 0.04])),
    "Laplace": (lambda D: D.Laplace(np.float32(1.0), np.float32(0.5)),
                1.0, 0.5),
    "Gumbel": (lambda D: D.Gumbel(np.float32(0.0), np.float32(1.0)),
               0.5772156649, math.pi ** 2 / 6),
    "Poisson": (lambda D: D.Poisson(np.float32(3.5)), 3.5, 3.5),
    "Multinomial": (lambda D: D.Multinomial(5, np.array(
        [0.2, 0.8], np.float32)), np.array([1.0, 4.0]),
        np.array([0.8, 0.8])),
    "Binomial": (lambda D: D.Binomial(np.array(10), np.float32(0.3)),
                 3.0, 2.1),
    "ContinuousBernoulli": (lambda D: D.ContinuousBernoulli(
        np.float32(0.3)), None, None),
    "Geometric": (lambda D: D.Geometric(np.float32(0.4)), 1.5, 3.75),
    "StudentT": (lambda D: D.StudentT(np.float32(6.0), np.float32(1.0),
                                      np.float32(2.0)), 1.0, 6.0),
    "MultivariateNormal": (lambda D: D.MultivariateNormal(
        np.array([1.0, -1.0], np.float32), covariance_matrix=np.array(
            [[2.0, 0.5], [0.5, 1.0]], np.float32)), np.array([1.0, -1.0]),
        np.array([2.0, 1.0])),
    "Independent": (lambda D: D.Independent(D.Normal(
        np.zeros(2, np.float32), np.ones(2, np.float32)), 1), 0.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(_SAMPLE))
def test_samples_follow_the_distribution(name):
    ctor, mean, var = _SAMPLE[name]
    dist = ctor(tp.distribution)
    tp.seed(123)
    s = dist.sample([N_SAMPLES]).numpy().astype(np.float64)
    tp.seed(123)
    s2 = ctor(tp.distribution).sample([N_SAMPLES]).numpy()
    np.testing.assert_array_equal(s, s2)
    assert np.all(np.isfinite(s))
    if mean is None:                     # the analytic mean of the port
        mean = float(dist.mean.numpy())
        var = float(np.var(s))
    m = s.mean(axis=0)
    se = np.sqrt(np.asarray(var) / N_SAMPLES)
    assert np.all(np.abs(m - mean) <= 4 * se), (m, mean, se)
    v = s.var(axis=0)
    # the variance's standard error, with a normal's kurtosis as a floor
    kurt = np.maximum(((s - m) ** 4).mean(axis=0) / np.maximum(v, 1e-12)
                      ** 2, 3.0)
    se_v = np.asarray(var) * np.sqrt((kurt - 1) / N_SAMPLES)
    assert np.all(np.abs(v - var) <= 4 * se_v), (v, var, se_v)


def test_lkj_samples_are_cholesky_factors_of_correlations():
    tp.seed(5)
    L = tp.distribution.LKJCholesky(5, 2.0).sample([2000]).numpy()
    C = L @ np.swapaxes(L, -1, -2)
    np.testing.assert_allclose(np.diagonal(C, axis1=-2, axis2=-1), 1.0,
                               atol=1e-5)
    assert np.all(np.triu(L, 1) == 0)
    # an off-diagonal correlation of LKJ(eta) on d=5 has variance
    # 1 / (2 eta + d - 1) = 1 / 8 and mean 0
    off = C[:, 0, 1]
    assert abs(off.mean()) < 4 * math.sqrt(0.125 / 2000)
    assert abs(off.var() - 0.125) < 0.02


@pytest.mark.parametrize("name", ["Normal", "Cauchy", "ContinuousBernoulli",
                                  "MultivariateNormal", "Independent"])
def test_rsample_is_differentiable_in_the_parameters(name):
    D = tp.distribution
    a = tp.to_tensor(arr(3, seed=70), stop_gradient=False)
    b = tp.to_tensor(pos(3, seed=71), stop_gradient=False)
    p = tp.to_tensor(np.array([0.2, 0.6, 0.8], np.float32),
                     stop_gradient=False)
    L = tp.to_tensor(np.tril(arr(3, 3, seed=72)) + 2 * np.eye(
        3, dtype=np.float32), stop_gradient=False)
    dist = {"Normal": lambda: D.Normal(a, b),
            "Cauchy": lambda: D.Cauchy(a, b),
            "ContinuousBernoulli": lambda: D.ContinuousBernoulli(p),
            "MultivariateNormal": lambda: D.MultivariateNormal(a, scale_tril=L),
            "Independent": lambda: D.Independent(D.Normal(a, b), 1)}[name]()
    s = dist.rsample([64])
    s.sum().backward()
    leaves = {"ContinuousBernoulli": [p],
              "MultivariateNormal": [a, L]}.get(name, [a, b])
    for t in leaves:
        assert t.grad is not None and np.all(np.isfinite(t.grad.numpy()))
        assert np.any(t.grad.numpy() != 0)
    if name == "Normal":     # d sum(loc + scale * eps) / d loc = 64
        np.testing.assert_allclose(a.grad.numpy(), 64.0)


def test_sample_only_classes_inherit_rsample():
    D = tp.distribution
    for cls in (D.Gamma, D.Beta, D.Uniform, D.Laplace):
        assert cls.rsample is D.Distribution.rsample
    t = D.TransformedDistribution(D.Normal(np.float32(0.0), np.float32(1.0)),
                                  [D.ExpTransform()])
    assert np.all(t.sample([10]).numpy() > 0)


# -- transforms ----------------------------------------------------------------

_T = {
    "Abs": (lambda T: T.AbsTransform(), arr(2, 3, seed=80)),
    "Affine": (lambda T: T.AffineTransform(np.float32(0.5),
                                           np.float32(-2.0)),
               arr(2, 3, seed=81)),
    "Exp": (lambda T: T.ExpTransform(), arr(2, 3, seed=82)),
    "Power": (lambda T: T.PowerTransform(np.float32(3.0)),
              pos(2, 3, seed=83)),
    "Sigmoid": (lambda T: T.SigmoidTransform(), arr(2, 3, seed=84)),
    "Tanh": (lambda T: T.TanhTransform(), arr(2, 3, seed=85)),
    "Softmax": (lambda T: T.SoftmaxTransform(), arr(2, 3, seed=86)),
    "Reshape": (lambda T: T.ReshapeTransform((3,), (3, 1)),
                arr(2, 3, seed=87)),
    "StickBreaking": (lambda T: T.StickBreakingTransform(),
                      arr(2, 3, seed=88)),
    "Chain": (lambda T: T.ChainTransform([T.AffineTransform(
        np.float32(1.0), np.float32(0.5)), T.ExpTransform()]),
        arr(2, 3, seed=89)),
    "Independent": (lambda T: T.IndependentTransform(T.ExpTransform(), 1),
                    arr(2, 3, seed=90)),
    "Stack": (lambda T: T.StackTransform([T.ExpTransform(),
                                          T.SigmoidTransform()], axis=0),
              arr(2, 3, seed=91)),
}

_NO_FLDJ = {"Abs", "Softmax"}


@pytest.mark.parametrize("meth", ["forward", "inverse",
                                  "forward_log_det_jacobian",
                                  "inverse_log_det_jacobian"])
@pytest.mark.parametrize("name", sorted(_T))
def test_transforms_match_jax(name, meth):
    ctor, x = _T[name]
    if "log_det" in meth and name in _NO_FLDJ:
        for pkg in (jp, tp):
            with pytest.raises(NotImplementedError):
                getattr(ctor(pkg.distribution), meth)(pkg.to_tensor(x))
        return
    if meth in ("inverse", "inverse_log_det_jacobian"):
        x = ctor(jp.distribution).forward(jp.to_tensor(x)).numpy()
    run_both(lambda a: getattr(ctor(jp.distribution), meth)(a),
             lambda a: getattr(ctor(tp.distribution), meth)(a), [x],
             gate=True)


@pytest.mark.parametrize("name", sorted(_T))
def test_transform_shapes(name):
    ctor = _T[name][0]
    for shape in ((4, 3), (2, 5, 3)):
        j, t = ctor(jp.distribution), ctor(tp.distribution)
        assert tuple(t.forward_shape(shape)) == tuple(j.forward_shape(shape))
        assert tuple(t.inverse_shape(shape)) == tuple(j.inverse_shape(shape))
    assert set(tp.distribution.transform.__all__) == \
        set(jp.distribution.transform.__all__)
