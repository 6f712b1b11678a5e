"""Model families with fast paths of their own.

Counterpart: ``gen_tpu/models/__init__.py``. Ported: the linear-Gaussian
state-space family (:mod:`.lgssm`) without ``lgssm_batch_weights``; the
HMM and GP families wait for later slices.
"""

from .lgssm import (KalmanResult, LGSSMParams, LinearGaussianSSM,
                    kalman_filter, kalman_smoother, lgssm, lgssm_kernel)

__all__ = ["LGSSMParams", "KalmanResult", "kalman_filter", "kalman_smoother",
           "lgssm_kernel", "LinearGaussianSSM", "lgssm"]
