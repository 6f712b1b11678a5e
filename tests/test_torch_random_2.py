"""The port's random tests, part 2 of 2: the cases imported
below from ``torch_random_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_random_cases import (  # noqa: F401
    test_uniform_and_randint_exact,
    test_normal_float32_within_4_ulp,
    test_vmap_over_keys_matches_jax_vmap,
    test_bernoulli_matches_jax,
    test_entry_points_default_to_the_card,
)
