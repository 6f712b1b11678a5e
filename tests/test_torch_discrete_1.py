"""The port's discrete tests, part 1 of 3: the cases imported
below from ``torch_discrete_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_discrete_cases import (  # noqa: F401
    test_logpdf_matches_gen_tpu,
)
