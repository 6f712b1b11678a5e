"""Linear-Gaussian state-space models (LGSSM) with exact Kalman inference.

Counterpart: ``gen_tpu/models/lgssm.py``. Ported: ``LGSSMParams``,
``KalmanResult``, ``kalman_filter``, ``kalman_smoother``,
``lgssm_kernel``, ``LinearGaussianSSM`` and ``lgssm``;
``lgssm_batch_weights`` waits for a later slice.

Where PyTorch forced a difference: gen_tpu's ``lax.scan`` over time is the
port's :func:`gen_tpu_torch.ops.scan.scan`, with the step's parameters as
explicit ``consts``: a plain Python loop outside staging, and one loop that
the staging pass keeps rolled inside it (:mod:`gen_tpu_torch.ops.scan`).
The step is gen_tpu's: a ``first`` flag in the carry selects the prior at
t = 0 by ``torch.where``, Joseph-form covariance updates, symmetrized, and
``cho_solve`` (``torch.cholesky_solve``) for the innovation and the gain.
The smoother keeps a Python loop (no staged path reads it).

Generative model (time-major, T steps, state dim D, obs dim P):

    x_0 ~ N(mu0, P0);   x_t = A x_{t-1} + N(0, Q)   t = 1..T-1
    y_t = C x_t + N(0, R)                            t = 0..T-1
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import random
from ..dists import mvnormal
from ..dists.distribution import Distribution, _f
from ..dynamic import gen
from ..ops.scan import scan

_LOG_2PI = 1.8378770664093453


class LGSSMParams(NamedTuple):
    A: torch.Tensor    # (D, D) transition
    Q: torch.Tensor    # (D, D) transition noise covariance
    C: torch.Tensor    # (P, D) emission
    R: torch.Tensor    # (P, P) emission noise covariance
    mu0: torch.Tensor  # (D,) initial mean
    P0: torch.Tensor   # (D, D) initial covariance


class KalmanResult(NamedTuple):
    log_ml: torch.Tensor           # scalar: log p(y_{0:T-1})
    filtered_means: torch.Tensor   # (T, D) E[x_t | y_{0:t}]
    filtered_covs: torch.Tensor    # (T, D, D)
    predicted_means: torch.Tensor  # (T, D) E[x_t | y_{0:t-1}]
    predicted_covs: torch.Tensor   # (T, D, D)


def _sym(m):
    return 0.5 * (m + m.transpose(-1, -2))


def _cho_solve(chol, b):
    """``jax.scipy.linalg.cho_solve((chol, True), b)`` for a vector or a
    matrix ``b``."""
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], chol)[:, 0]
    return torch.cholesky_solve(b, chol)


def _kalman_step(consts, carry, y):
    """One step of the filter (gen_tpu's ``step``): predict (the prior at
    the first step, by a select), innovation, gain, Joseph-form update."""
    A, Q, C, R, mu0, P0 = consts
    m, P, first = carry
    p = C.shape[-2]
    eye_d = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    m_pred = torch.where(first, mu0, A @ m)
    P_pred = torch.where(first, P0, _sym(A @ P @ A.T + Q))
    # innovation
    v = y - C @ m_pred
    S = _sym(C @ P_pred @ C.T + R)
    chol_s = torch.linalg.cholesky(S)
    s_inv_v = _cho_solve(chol_s, v)
    lml = -0.5 * (v @ s_inv_v + p * _LOG_2PI) \
        - torch.sum(torch.log(torch.diagonal(chol_s)))
    # gain: K = P_pred C^T S^-1
    K = _cho_solve(chol_s, C @ P_pred).T
    m_f = m_pred + K @ v
    ImKC = eye_d - K @ C
    P_f = _sym(ImKC @ P_pred @ ImKC.T + K @ R @ K.T)
    return (m_f, P_f, torch.zeros_like(first)), (lml, m_f, P_f, m_pred,
                                                  P_pred)


def kalman_filter(params: LGSSMParams, ys) -> KalmanResult:
    """Exact filtering and marginal likelihood, one :func:`scan` over time.
    Differentiable with respect to every field of ``params``; Joseph-form
    covariance updates. ``ys``: (T, P)."""
    A, Q, C, R, mu0, P0 = (_f(p) for p in params)
    ys = _f(ys)
    dt = A.dtype
    for t_ in (Q, C, R, mu0, P0, ys):
        dt = torch.promote_types(dt, t_.dtype)
    A, Q, C, R, mu0, P0, ys = (x.to(dt) for x in (A, Q, C, R, mu0, P0, ys))
    first = torch.ones((), dtype=torch.bool, device=A.device)
    _, (lml, m_f, P_f, m_p, P_p) = scan(_kalman_step, (mu0, P0, first), ys,
                                        (A, Q, C, R, mu0, P0))
    return KalmanResult(torch.sum(lml), m_f, P_f, m_p, P_p)


def kalman_smoother(params: LGSSMParams, ys):
    """Rauch-Tung-Striebel smoother: ``(means (T, D), covs (T, D, D))`` of
    p(x_t | y_{0:T-1}), a backward loop over the filter's output."""
    A = _f(params.A)
    res = kalman_filter(params, ys)
    m_f, P_f = res.filtered_means, res.filtered_covs
    A = A.to(m_f.dtype)
    T = m_f.shape[0]
    means, covs = [m_f[-1]], [P_f[-1]]
    m_next, P_next = m_f[-1], P_f[-1]
    for t in range(T - 2, -1, -1):
        m_pred, P_pred = res.predicted_means[t + 1], res.predicted_covs[t + 1]
        chol = torch.linalg.cholesky(P_pred)
        # J = P_filt A^T P_pred^-1
        J = _cho_solve(chol, A @ P_f[t]).T
        m_next = m_f[t] + J @ (m_next - m_pred)
        P_next = _sym(P_f[t] + J @ (P_next - P_pred) @ J.T)
        means.append(m_next)
        covs.append(P_next)
    return torch.stack(means[::-1]), torch.stack(covs[::-1])


@gen
def lgssm_kernel(t, prev_x, A, Q, C, R, mu0, P0):
    """Unfold/SMC kernel for the uncollapsed LGSSM: addresses "x", "y" per
    step; the first step (``t == 0``) draws from the prior, by a select as
    in gen_tpu, so that ``t`` may be a batched tensor."""
    first = torch.as_tensor(t) == 0
    mean = torch.where(first, mu0, A @ prev_x)
    cov = torch.where(first, P0, Q)
    x = mvnormal(mean, cov) @ "x"
    mvnormal(C @ x, R) @ "y"
    return x


class LinearGaussianSSM(Distribution):
    """``lgssm(T)``: the collapsed observation sequence y_{0:T-1} (shape
    (T, P)) of an LGSSM as one Distribution; its logpdf is the exact Kalman
    marginal likelihood, differentiable with respect to all six
    parameters. Inside a ``@gen`` model, HMC/NUTS over the dynamics runs on
    the exact collapsed posterior."""

    arg_grads = (True, True, True, True, True, True)

    def __init__(self, num_steps: int):
        self.num_steps = int(num_steps)

    def __repr__(self):
        return f"lgssm({self.num_steps})"

    def sample(self, key, A, Q, C, R, mu0, P0):
        A, Q, C, R, mu0, P0 = (_f(v) for v in (A, Q, C, R, mu0, P0))
        chol_q = torch.linalg.cholesky(Q)
        chol_r = torch.linalg.cholesky(R)
        chol_p0 = torch.linalg.cholesky(P0)
        x, ys = mu0, []
        for t, k in enumerate(random.split(key, self.num_steps)):
            kx, ky = random.split(k)
            ex = random.normal(kx, mu0.shape, mu0.dtype)
            x = (mu0 + chol_p0 @ ex) if t == 0 else (A @ x + chol_q @ ex)
            ey = random.normal(ky, (C.shape[-2],), mu0.dtype)
            ys.append(C @ x + chol_r @ ey)
        return torch.stack(ys)

    def logpdf(self, ys, A, Q, C, R, mu0, P0):
        return kalman_filter(LGSSMParams(A, Q, C, R, mu0, P0), ys).log_ml


def lgssm(num_steps: int) -> LinearGaussianSSM:
    """The collapsed-LGSSM distribution with a static length."""
    return LinearGaussianSSM(num_steps)
