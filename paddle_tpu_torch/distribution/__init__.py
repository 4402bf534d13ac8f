"""paddle.distribution of the port (counterpart of
``paddle_tpu/distribution``): the distributions, the KL registry and the
transforms."""
from .distributions import (  # noqa: F401
    Bernoulli, Beta, Binomial, Categorical, Cauchy, Chi2,
    ContinuousBernoulli, Dirichlet, Distribution, Exponential,
    ExponentialFamily, Gamma, Geometric, Gumbel, Independent, LKJCholesky,
    Laplace, LogNormal, Multinomial, MultivariateNormal, Normal, Poisson,
    StudentT, TransformedDistribution, Uniform, kl_divergence, register_kl)

from . import chi2, kl, lkj_cholesky, transform  # noqa: F401,E402
from .transform import *  # noqa: F401,F403,E402
