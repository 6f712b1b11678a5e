"""The port's resample tests, part 2 of 2: the cases imported
below from ``torch_resample_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_resample_cases import (  # noqa: F401
    test_parents_equal_gen_tpu_large,
    test_offspring_proportional_to_weights,
    test_rank_merge_any_query_length,
    test_positions_round_like_xla,
    test_source_and_build_job,
    test_kernel_matches_plain_on_cuda,
)
