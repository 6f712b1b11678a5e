"""The port's smc tests, part 2 of 2: the cases imported
below from ``torch_smc_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_smc_cases import (  # noqa: F401
    test_particle_filter_step_with_proposal,
    test_particle_filter_step_discard_error,
    test_smc_genealogy_and_trajectories,
    test_smc_run_matches_gen_tpu,
    test_arena_trace_views,
    test_smc_run_matches_kalman,
    test_residual_above_gumbel_limit_is_unbiased,
    test_pf_log_ml_matches_forward_algorithm,
)
