"""The port's update tests, part 2 of 3: the cases imported
below from ``torch_update_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_update_cases import (  # noqa: F401
    test_not_visited_errors,
    test_masked_constraints_raise,
    test_propose,
    test_rebuild_is_keyfree_update,
    test_unfold_generate_simulate_assess,
)
