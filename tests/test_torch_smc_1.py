"""The port's smc tests, part 1 of 2: the cases imported
below from ``torch_smc_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_smc_cases import (  # noqa: F401
    test_importance_sampling_and_resampling,
    test_resample_parents,
    test_particle_filter_api,
)
