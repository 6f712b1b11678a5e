"""The port's mixed tests, part 1 of 2: the cases imported
below from ``torch_mixed_cases.py``, whose docstring says what they
check. A part file holds at most 11 cases.
"""

from torch_mixed_cases import (  # noqa: F401
    test_map_generate_and_update_weights_match,
    test_discover_discrete_sites_matches,
    test_engine_dispatch_matches_gen_tpu,
    test_gmm_staged_extended_logp_matches_flat_target,
)
