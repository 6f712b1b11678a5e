"""The port's sample tests, part 1 of 2: the cases imported
below from ``torch_sample_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_sample_cases import (  # noqa: F401
    test_layout_helpers_match_gen_tpu,
    test_output_layout_matches_gen_tpu,
)
