"""The port's hmc fused tests, part 2 of 2: the cases imported
below from ``torch_hmc_fused_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_hmc_fused_cases import (  # noqa: F401
    test_twin_matches_interpret_kernel_frozen_coordinate,
    test_twin_own_randomness_samples_the_gaussian,
    test_chunked_runner_stitches_chunks,
    test_cuda_source_renders,
    test_chip_smoke_refuses_without_cuda,
    test_kernel_matches_twin_on_cuda,
)
