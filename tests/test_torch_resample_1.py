"""The port's resample tests, part 1 of 2: the cases imported
below from ``torch_resample_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_resample_cases import (  # noqa: F401
    test_parents_equal_gen_tpu,
)
