"""The port's nuts fused tests, part 1 of 2: the cases imported
below from ``torch_nuts_fused_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_nuts_fused_cases import (  # noqa: F401
    test_pair_twin_matches_gen_tpu,
    test_kernel_plain_version_matches_gen_tpu,
    test_pair_schedule_moments_match_exact,
    test_staged_eight_schools_value_and_grad,
)
