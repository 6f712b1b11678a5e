"""The fused engines on the phase-10 models against gen_tpu: part 2 of 2
(K3's and K6's plain versions).

The cases live in ``torch_stream_engines_cases.py``.
"""

from torch_stream_engines_cases import (  # noqa: F401
    test_nuts_plain_versions_match_gen_tpu,
)
