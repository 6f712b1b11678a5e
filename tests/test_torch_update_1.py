"""The port's update tests, part 1 of 3: the cases imported
below from ``torch_update_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_update_cases import (  # noqa: F401
    test_update_dynamic,
    test_regenerate_dynamic,
)
