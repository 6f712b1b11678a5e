"""The port's discrete tests, part 3 of 3: the cases imported
below from ``torch_discrete_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_discrete_cases import (  # noqa: F401
    test_exact_samplers_match_gen_tpu_under_the_same_key,
    test_poisson_sampler_chi_square,
    test_binom_sampler_chi_square,
    test_neg_binom_sampler_chi_square,
    test_multinomial_sampler_chi_square,
    test_gamma_sampler_chi_square,
)
