"""The port's nuts fused tests, part 2 of 2: the cases imported
below from ``torch_nuts_fused_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_nuts_fused_cases import (  # noqa: F401
    test_extract_completed_draws_matches_gen_tpu,
    test_chunked_driver_matches_gen_tpu,
    test_collect_draws_matches_stitched_extraction,
    test_unpaired_engine_raises_naming_its_kernel,
    test_cuda_source_renders,
    test_kernel_matches_plain_version_on_cuda,
)
