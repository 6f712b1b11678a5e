"""The port's mixed tests, part 2 of 2: the cases imported
below from ``torch_mixed_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_mixed_cases import (  # noqa: F401
    test_gmm_fused_engine_runs_tiny,
    test_scalar_categorical_runs_gibbs_nuts,
    test_partly_observed_vector_leaf_raises,
    test_mixed_path_refuses_arguments_it_would_ignore,
    test_mixed_fused_sample_requires_observations,
    test_stitched_chunks_are_each_chains_first_completed_draws,
)
