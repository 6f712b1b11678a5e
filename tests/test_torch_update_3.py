"""The port's update tests, part 3 of 3: the cases imported
below from ``torch_update_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_update_cases import (  # noqa: F401
    test_unfold_update,
    test_unfold_regenerate,
    test_unfold_regenerate_per_step_selection_raises,
    test_unfold_structural_equality_and_errors,
)
