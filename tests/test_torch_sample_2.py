"""The port's sample tests, part 2 of 2: the cases imported
below from ``torch_sample_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_sample_cases import (  # noqa: F401
    test_auto_engine_matches_gen_tpu,
    test_auto_fallback_warns_and_records_reason,
    test_refusals,
    test_dense_mass_refused_past_the_residual_cap,
    test_slice_nuts_fused_matches_gen_tpu,
)
