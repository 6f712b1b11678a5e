from .continuous import (BroadcastedNormal, Gamma, MvNormal, Normal,
                         NormalLinear, StudentT, beta, broadcasted_normal,
                         cauchy, exponential, gamma, inv_gamma, laplace,
                         mvnormal, normal, normal_linear, student_t, uniform,
                         uniform_continuous)
from .discrete import (bernoulli, binom, categorical, dirac, geometric,
                       labeled_categorical, multinomial, neg_binom, poisson,
                       uniform_discrete)
from .distribution import Distribution

__all__ = ["Distribution", "BroadcastedNormal", "Gamma", "MvNormal", "Normal",
           "NormalLinear", "StudentT", "gamma", "normal", "normal_linear",
           "broadcasted_normal", "mvnormal", "uniform", "uniform_continuous",
           "beta", "inv_gamma", "exponential", "cauchy", "laplace",
           "student_t", "bernoulli", "categorical", "labeled_categorical",
           "uniform_discrete", "poisson", "binom", "geometric", "neg_binom",
           "dirac", "multinomial"]
