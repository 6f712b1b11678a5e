from .continuous import (BroadcastedNormal, Gamma, MvNormal, Normal,
                         NormalLinear, PiecewisePoissonProcess, StudentT,
                         beta, beta_uniform, broadcasted_normal, cauchy,
                         dirichlet, exponential, gamma, inv_gamma, laplace,
                         mvnormal, normal, normal_linear,
                         piecewise_poisson_process, piecewise_uniform,
                         student_t, uniform, uniform_continuous)
from .discrete import (bernoulli, binom, categorical, dirac, geometric,
                       labeled_categorical, multinomial, neg_binom, poisson,
                       uniform_discrete)
from .dist_dsl import (ArgMappedDistribution, Bijection,
                       RelabeledDistribution, TransformedDistribution,
                       affine_bijection, dist, enum_dist, exp_of, log_of)
from .distribution import Distribution
from .mixture import HeterogeneousMixture, HomogeneousMixture

__all__ = ["Distribution", "BroadcastedNormal", "Gamma", "MvNormal", "Normal",
           "NormalLinear", "StudentT", "gamma", "normal", "normal_linear",
           "broadcasted_normal", "mvnormal", "uniform", "uniform_continuous",
           "beta", "beta_uniform", "inv_gamma", "exponential", "cauchy",
           "laplace", "piecewise_uniform", "student_t", "dirichlet",
           "piecewise_poisson_process", "PiecewisePoissonProcess",
           "HomogeneousMixture", "HeterogeneousMixture",
           "TransformedDistribution", "RelabeledDistribution",
           "ArgMappedDistribution", "Bijection", "affine_bijection",
           "exp_of", "enum_dist", "log_of", "dist",
           "bernoulli", "categorical", "labeled_categorical",
           "uniform_discrete", "poisson", "binom", "geometric", "neg_binom",
           "dirac", "multinomial"]
