"""The port's sample engines tests, part 2 of 2: the cases imported
below from ``torch_sample_engines_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_sample_engines_cases import (  # noqa: F401
    test_partial_selection_conditions_per_chain,
    test_structured_mass_on_correlated_gaussian,
)
