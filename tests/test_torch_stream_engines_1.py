"""The fused engines on the phase-10 models against gen_tpu: part 1 of 2
(K1's plain version, the engine choice, the warmup's evaluator).

The cases live in ``torch_stream_engines_cases.py``.
"""

from torch_stream_engines_cases import (  # noqa: F401
    test_auto_engine_matches_gen_tpu_on_both_models,
    test_chees_warmup_takes_a_batched_evaluator,
    test_hmc_plain_version_matches_gen_tpu_reference,
)
