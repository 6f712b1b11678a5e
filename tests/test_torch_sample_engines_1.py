"""The port's sample engines tests, part 1 of 2: the cases imported
below from ``torch_sample_engines_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_sample_engines_cases import (  # noqa: F401
    test_engine_recovers_conjugate_posterior,
)
