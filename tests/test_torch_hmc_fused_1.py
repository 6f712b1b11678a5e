"""The port's hmc fused tests, part 1 of 2: the cases imported
below from ``torch_hmc_fused_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_hmc_fused_cases import (  # noqa: F401
    test_staged_value_and_grad_regression,
    test_staged_value_and_grad_elementwise_ops,
    test_unsupported_op_raises_with_its_name,
    test_twin_matches_interpret_kernel_regression,
)
