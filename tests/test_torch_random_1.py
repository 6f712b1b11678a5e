"""The port's random tests, part 1 of 2: the cases imported
below from ``torch_random_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_random_cases import (  # noqa: F401
    test_key_split_fold_in_bits_exact,
)
