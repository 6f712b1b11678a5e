from .continuous import (Gamma, Normal, NormalLinear, gamma, normal,
                         normal_linear)
from .discrete import (bernoulli, binom, categorical, dirac, geometric,
                       labeled_categorical, multinomial, neg_binom, poisson,
                       uniform_discrete)
from .distribution import Distribution

__all__ = ["Distribution", "Gamma", "Normal", "NormalLinear", "gamma",
           "normal", "normal_linear", "bernoulli", "categorical",
           "labeled_categorical", "uniform_discrete", "poisson", "binom",
           "geometric", "neg_binom", "dirac", "multinomial"]
